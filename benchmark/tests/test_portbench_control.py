"""The control comes out not correct: the plain reference computed with every
product's operands rounded to float8 (the precision below the cells' bf16)
reads beyond the cells' limits, while the program stays inside them.

On the CPU the model is cut to a size a test run holds (C=512, 8 blocks,
32x32 images): the control's gap grows with width and depth, so there it
reads about 0.10 against the ViT-H/14 cell's 0.15-0.18 (on the card, three
seeds). The marked test runs the control at each cell's own size on a card."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate, harness, weights
from benchmark.entries.infer import row_gaps
from benchmark.reference import octic_vit
from benchmark.tests import tiny


def limits(cell: str) -> dict:
    return {k: v["limit"] for k, v in harness.find_cell(cell).limits.items()}


def test_float8_control_fails_the_inference_limit():
    from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer

    limit = limits("hybrid_vith14.infer_b64")["logit_gap"]
    model = OcticVisionTransformer(img_size=32, patch_size=4, embed_dim=512, depth=8,
                                   num_heads=8, qkv_bias=True, num_classes=100,
                                   dtype=torch.bfloat16, device="cpu").eval()
    p = weights.seeded(weights.shapes_of(model), "vit_seeded", 2 ** 31 + 5, "cpu")
    weights.load_into(model, p)
    cfg = dict(patch_size=4, num_heads=8, depth=8, break_layer=4)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        ref = octic_vit.forward(p, cfg, x.float())
        control = float(row_gaps(octic_vit.forward(p, cfg, x.float(), octic_vit.fp8), ref).max())
        program = float(row_gaps(model(x).float(), ref).max())
    assert program < limit < control


@pytest.mark.parametrize("mix_name", ["deit_b256", "ssl_b256"])
def test_float8_control_fails_a_train_limit(mix_name):
    real = next(c for c in tiny.cell_names() if c.endswith(mix_name))
    lim = limits(real)
    keep: list = []
    res = harness.run_cell(tiny.spec(mix_name, harness.find_cell(real).limits), 2 ** 31 + 23,
                           0.2, False, "cpu", time.perf_counter(), keep=keep)
    assert res["correct"]
    control = calibrate.control_readings(keep[0])["control"]
    assert any(control[k] > lim[k] for k in lim), control


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["hybrid_vith14.infer_b64", "hybrid_vith14.deit_b256",
                                  "hybrid_vitl16_dinov2.ssl_b256",
                                  "hybrid_vitl16_dinov2.features_b256"])
def test_float8_control_at_the_cells_size(cell):
    """On a card: the cell's program inside its limits, its control beyond one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keep: list = []
    spec = harness.find_cell(cell)
    res = harness.run_cell(spec, 2 ** 31 + 29, 2.0, False, "cuda", time.perf_counter(),
                           keep=keep)
    assert res["correct"], res["checks"]
    control = calibrate.control_readings(keep[0])["control"]
    lim = limits(cell)
    assert any(control[k] > lim[k] for k in lim), control
