"""Whole-model parity of the port with the JAX package on the CPU in f32:
the hybrid OcticVisionTransformer with the exact bench.py flag set and the
standard VisionTransformer, from both the unscanned and the scanned flax
parameter trees (params_from_jax, strict loading). atol 1e-4 is the bar of
tests/test_models_kernels.py. Also: chip_smoke.py refuses to run without a
CUDA device."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.models import OcticVisionTransformer as JOctic
from octic_vits_tpu.models import VisionTransformer as JViT
from octic_vits_tpu_torch import create_model
from octic_vits_tpu_torch.models import OcticVisionTransformer, VisionTransformer
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH_FLAGS = dict(use_pallas_attention=True, use_pallas_linear=True,
                   use_pallas_std_mlp=True, flat_e_carry=True, fuse_mlp=True, fuse_qkv=True)
# hybrid_vit_small_test, and the sizes of tests/test_models_kernels.py without
# the invariant head (the port carries the hybrid break only)
CONFIGS = {
    "hybrid_vit_small_test": dict(img_size=64, patch_size=8, embed_dim=64, depth=4,
                                  num_heads=2, mlp_ratio=2.0, qkv_bias=True, num_classes=10),
    "kernels_test_sizes": dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2,
                               mlp_ratio=2.0, qkv_bias=True, num_classes=10, init_scale=1.0),
}


def _images(size, seed=0):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _perturbed_params(model, img, seed):
    """flax init, then noise on every leaf so no LayerScale or norm affine is
    at its trivial value."""
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(img))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params
    )


def _port_logits(tmodel, params, img):
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    with torch.no_grad():
        return tmodel.eval()(torch.from_numpy(img)).numpy()


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hybrid_model_matches_jax(config, scan):
    cfg = CONFIGS[config]
    img = _images(cfg["img_size"])
    jmodel = JOctic(**cfg, **BENCH_FLAGS, scan_blocks=scan)
    params = _perturbed_params(jmodel, img, seed=1)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    # the registry's entry for the small test config; the other by its constructor
    tmodel = (create_model(config) if config == "hybrid_vit_small_test"
              else OcticVisionTransformer(**cfg))
    ours = _port_logits(tmodel, params, img)
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("scan", [False, True])
def test_standard_model_matches_jax(scan):
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=2, mlp_ratio=2.0,
               qkv_bias=True, num_classes=10, init_scale=1.0, norm_eps=1e-6)
    img = _images(32, seed=4)
    jmodel = JViT(**cfg, use_pallas_attention=True, use_pallas_mlp=True, scan_blocks=scan)
    params = _perturbed_params(jmodel, img, seed=5)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    np.testing.assert_allclose(_port_logits(VisionTransformer(**cfg), params, img), ref,
                               atol=ATOL)


def test_chip_smoke_fails_without_gpu():
    """On a machine without a CUDA device the chip smoke exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
