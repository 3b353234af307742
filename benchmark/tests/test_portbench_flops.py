"""The frozen arithmetic: the analytic MAC counts of ViT-H/14 and the op
layer's bounds at the kernel table's shapes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import flops, work

VITH14 = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                     "hybrid_vith14.json").read_text())


def test_vith14_gmacs():
    assert flops.vit_macs(VITH14) / 1e9 == pytest.approx(96.6, abs=0.05)
    standard = dict(VITH14, break_layer=0)
    assert flops.vit_macs(standard) / 1e9 == pytest.approx(167.3, abs=0.05)
    assert flops.flops_per_image(VITH14) == 2 * flops.vit_macs(VITH14)


@pytest.mark.parametrize("op,ms", [("octic_attention_fused_qkv", 0.0525),
                                   ("mlp_d8_fused", 0.0817),
                                   ("standard_attention", 0.0503),
                                   ("dense_gelu", 0.2180)])
def test_forward_bounds_at_vith14_b64(op, ms):
    env = work.shape_env(64, 257, 1280, 16, True)
    bound = work.bound_s(*work.work(work.load_ops()[op], "fwd", env)) * 1e3
    assert bound == pytest.approx(ms, abs=5e-5)


def test_expressions_are_plain_arithmetic():
    assert work.evaluate("2 * (m + 3) / c8 - -1", {"m": 5, "c8": 4}) == 5.0
    with pytest.raises(ValueError):
        work.evaluate("__import__('os')", {})
    with pytest.raises(ValueError):
        work.evaluate("x", {"m": 1})
