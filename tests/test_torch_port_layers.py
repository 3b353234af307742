"""Layer parity: each port layer (octic_vits_tpu_torch.layers) against its
flax counterpart in the configuration the benchmark runs (flat-E tuple,
fused qkv + attention, fused MLP, Pallas standard attention and fc1), on
the CPU in f32. Weights are the flax layer's own, perturbed so LayerNorm
affines and LayerScales are not trivial, and reach the port through
params_from_jax with strict loading."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.layers import d8_layers as jd8
from octic_vits_tpu.layers import vit_layers as jvit
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.layers import vit_layers as tvit
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-5
B, N, C, HEADS = 2, 11, 64, 2
C8 = C // 8


def _flat_e_tuple(seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, N, C8)).astype(np.float32) for _ in range(4)]
    return xs + [rng.standard_normal((B, N, 4 * C8)).astype(np.float32)]


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree
    )


def _run_both(jmod, tmod, inputs, seed=0):
    """init the flax module, perturb its params, load them into the torch
    module and return both outputs (JAX as numpy)."""
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    variables = {"params": _perturb(jmod.init(jax.random.PRNGKey(seed), jin)["params"], seed)}
    tmod.load_state_dict(params_from_jax(variables, tmod), strict=True)
    tmod.eval()
    theirs = jmod.apply(variables, jin)
    tin = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), inputs)
    with torch.no_grad():
        ours = tmod(tin)
    return ours, theirs


def _assert_tuple(ours, theirs, atol=ATOL):
    theirs = tuple(theirs)
    assert len(ours) == len(theirs)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        t = np.asarray(t)
        np.testing.assert_allclose(o.numpy(), t.reshape(o.shape), atol=atol, rtol=1e-5,
                                   err_msg=f"slot {i}")
        assert o.numel() == t.size


def test_linear_d8():
    ours, theirs = _run_both(jd8.LinearD8(3 * C), td8.LinearD8(C, 3 * C), tuple(_flat_e_tuple(0)))
    _assert_tuple(ours, theirs)


def test_layer_norm_d8():
    ours, theirs = _run_both(jd8.LayerNormD8(), td8.LayerNormD8(C), tuple(_flat_e_tuple(1)))
    _assert_tuple(ours, theirs)


def test_patch_embed_d8():
    img = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ours, theirs = _run_both(jd8.PatchEmbedD8(patch_size=8, embed_dim=C),
                             td8.PatchEmbedD8(8, C), img)
    # the flax embed returns E as [B, N, 2, C/4]; flattened it is the flat-E row order
    _assert_tuple(ours, theirs)


def test_attention_d8_fused_qkv():
    ours, theirs = _run_both(
        jd8.AttentionD8(num_heads=HEADS, qkv_bias=True, use_pallas_attention=True,
                        fuse_qkv=True),
        td8.AttentionD8(C, HEADS, qkv_bias=True), tuple(_flat_e_tuple(3)))
    _assert_tuple(ours, theirs)


def test_mlp_d8_fused():
    ours, theirs = _run_both(
        jd8.MlpD8(hidden_features=2 * C, use_pallas_linear=True, fuse_mlp=True),
        td8.MlpD8(C, 2 * C), tuple(_flat_e_tuple(4)))
    _assert_tuple(ours, theirs)


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_block_d8_bench_flags(qkv_bias):
    ours, theirs = _run_both(
        jd8.BlockD8(num_heads=HEADS, mlp_ratio=2.0, qkv_bias=qkv_bias, layerscale_init=1.0,
                    use_pallas_linear=True, use_pallas_attention=True, fuse_qkv=True,
                    fuse_mlp=True),
        td8.BlockD8(C, HEADS, mlp_ratio=2.0, qkv_bias=qkv_bias, layerscale_init=1.0),
        tuple(_flat_e_tuple(5)))
    _assert_tuple(ours, theirs)


def test_block_pallas_flags():
    x = np.random.default_rng(6).standard_normal((B, N, C)).astype(np.float32)
    ours, theirs = _run_both(
        jvit.Block(num_heads=HEADS, qkv_bias=True, layerscale_init=1.0, norm_eps=1e-6,
                   use_pallas_attention=True, use_pallas_mlp=True),
        tvit.Block(C, HEADS, qkv_bias=True, layerscale_init=1.0, norm_eps=1e-6), x)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=1e-5)


def test_patch_embed():
    img = np.random.default_rng(7).standard_normal((2, 16, 16, 3)).astype(np.float32)
    ours, theirs = _run_both(jvit.PatchEmbed(patch_size=8, embed_dim=C), tvit.PatchEmbed(8, C),
                             img)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=1e-5)
