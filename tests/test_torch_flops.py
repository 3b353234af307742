"""The port's analytic MAC counts (octic_vits_tpu_torch/utils/flops.py)
against the JAX package's on the six models of the paper's complexity table
(scripts/complexity.py:30-41) and the README bounds that
tests/test_convert_and_utils.py checks: equal to the last bit."""

import dataclasses

import pytest

from octic_vits_tpu.utils import flops as J
from octic_vits_tpu_torch.utils import flops as T

# scripts/complexity.py:30-41: (name, kind, patch, width, depth)
MODELS = [("deit_huge_patch14_LS", "standard", 14, 1280, 32),
          ("d8_inv_early_deit_huge_patch14", "invariant", 14, 1280, 32),
          ("hybrid_deit_huge_patch14", "hybrid", 14, 1280, 32),
          ("deit_large_patch16_LS", "standard", 16, 1024, 24),
          ("d8_inv_early_deit_large_patch16", "invariant", 16, 1024, 24),
          ("hybrid_deit_large_patch16", "hybrid", 16, 1024, 24)]


def _macs(mod, kind, **spec):
    s = mod.ViTSpec(**spec)
    if kind == "standard":
        return mod.standard_vit_macs(s)
    return mod.octic_vit_macs(s, invariant=kind == "invariant")


@pytest.mark.parametrize("name,kind,patch,dim,depth", MODELS)
def test_complexity_table_macs_equal_jax(name, kind, patch, dim, depth):
    spec = dict(patch_size=patch, embed_dim=dim, depth=depth)
    ours, theirs = _macs(T, kind, **spec), _macs(J, kind, **spec)
    assert ours == theirs, name
    assert T.gmacs(ours) == J.gmacs(theirs)


@pytest.mark.parametrize("spec", [dict(img_size=518, patch_size=14, embed_dim=1536, depth=40,
                                       num_heads=24, num_register_tokens=4),
                                  dict(img_size=32, patch_size=8, embed_dim=32, depth=2,
                                       mlp_ratio=2.0, num_classes=10)])
def test_other_specs_and_options_equal_jax(spec):
    """Registers, another mlp ratio and head, and every break layer and the
    invariant projection of the octic count."""
    s, js = T.ViTSpec(**spec), J.ViTSpec(**spec)
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    assert s.tokens == js.tokens
    assert T.standard_vit_macs(s) == J.standard_vit_macs(js)
    for brk in (None, 0, 1, s.depth):
        for inv in (False, True):
            assert (T.octic_vit_macs(s, break_layer=brk, invariant=inv)
                    == J.octic_vit_macs(js, break_layer=brk, invariant=inv)), (brk, inv)


def test_flops_match_readme_tables():
    """The cases of tests/test_convert_and_utils.py:test_flops_match_readme_tables
    on the port: hybrid ViT-H/14 ~102 G MACs, standard ~167 G, hybrid ViT-L/16
    ~38 G, standard ~62 G, the ~40% reduction (reference: README.md:36,
    :112-143)."""
    h14 = T.ViTSpec(patch_size=14, embed_dim=1280, depth=32)
    assert 95 < T.gmacs(T.octic_vit_macs(h14)) < 108
    assert 160 < T.gmacs(T.standard_vit_macs(h14)) < 175
    l16 = T.ViTSpec(patch_size=16, embed_dim=1024, depth=24)
    assert 34 < T.gmacs(T.octic_vit_macs(l16)) < 42
    assert 58 < T.gmacs(T.standard_vit_macs(l16)) < 66
    ratio = T.octic_vit_macs(h14) / T.standard_vit_macs(h14)
    assert 0.55 < ratio < 0.65
