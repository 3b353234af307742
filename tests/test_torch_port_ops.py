"""Parity of the port's plain ops (octic_vits_tpu_torch.ops, .d8) with the
JAX package's kernel functions on the CPU, in f32. Inputs come from a seeded
numpy generator and go to both sides; the JAX kernels run in interpret mode,
as the JAX package's own tests run them. On CPU tensors the port's kernel
wrappers take their plain versions, so calling the wrapper here checks the
dispatch as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.d8 import group as jgroup
from octic_vits_tpu.d8 import posembed as jpos
from octic_vits_tpu.ops.gelu_d8 import gelu_d8_eager as j_gelu_d8
from octic_vits_tpu.ops.pallas_attention import (
    octic_attention_fused_qkv as j_octic_fused,
    standard_attention as j_standard,
)
from octic_vits_tpu.ops.pallas_dense import dense_gelu as j_dense_gelu
from octic_vits_tpu.ops.pallas_linear import mlp_d8_fused as j_mlp_fused
from octic_vits_tpu_torch import ops
from octic_vits_tpu_torch.d8 import group as tgroup
from octic_vits_tpu_torch.d8 import posembed as tpos

torch.set_num_threads(1)
ATOL = RTOL = 1e-5  # f32 on both sides; the JAX f32 kernels use a 1.5e-7 erf


def _rng(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(
        ours.detach().numpy(), np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg
    )


@pytest.mark.parametrize("direction", ["iso_to_reg", "reg_to_iso"])
def test_butterflies_exact(direction):
    xs = [_n(_rng(i), 3, 5) for i in range(8)]
    name = "isotypic_to_regular" if direction == "iso_to_reg" else "regular_to_isotypic"
    ours = getattr(tgroup, name)(tuple(_t(x) for x in xs))
    theirs = getattr(jgroup, name)(tuple(jnp.asarray(x) for x in xs))
    for i in range(8):
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(theirs[i]))


def test_packers_exact():
    rng = _rng(1)
    xs = tuple(_n(rng, 2, 3, 4) for _ in range(8))
    for pack, unpack in (("pack_8_to_5", "unpack_5_to_8"), ("pack_8_to_5f", "unpack_5f_to_8")):
        ours = getattr(tgroup, pack)(tuple(_t(x) for x in xs))
        theirs = getattr(jgroup, pack)(tuple(jnp.asarray(x) for x in xs))
        for o, t in zip(ours, theirs):
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
        back = getattr(tgroup, unpack)(ours)
        for o, x in zip(back, xs):
            np.testing.assert_array_equal(o.numpy(), x)


def test_unfold_quadrant_and_resize():
    rng = _rng(2)
    quad = [_n(rng, 3, 3, 4) for _ in range(6)]
    ours = tpos.unfold_quadrant(tuple(_t(q) for q in quad), dim=0)
    theirs = jpos.unfold_quadrant(tuple(jnp.asarray(q) for q in quad), dim=0)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    grid = _n(rng, 6, 6, 4)
    _close(tpos.resize_grid(_t(grid), (10, 8)), jpos.resize_grid(jnp.asarray(grid), (10, 8)))
    np.testing.assert_array_equal(tpos._cubic_resize_matrix(6, 9), jpos._cubic_resize_matrix(6, 9))


@pytest.mark.parametrize("flat_e", [True, False])
def test_gelu_d8_eager(flat_e):
    rng = _rng(3)
    xs = [_n(rng, 2, 5, 4) for _ in range(4)]
    xs.append(_n(rng, 2, 5, 16) if flat_e else _n(rng, 2, 5, 2, 8))
    ours = ops.gelu_d8_eager(tuple(_t(x) for x in xs))
    theirs = j_gelu_d8(tuple(jnp.asarray(x) for x in xs))
    for o, t in zip(ours, theirs):
        _close(o, t)


# the card gates' head widths and token counts (csrc/attention_std.cu's
# boxes: 16, 16 + 8, 32, 64, 64 + 16; N = 257 and 65 fold key N - 1 in as a
# rank-1 update, 37 and 197 end on a masked key tile)
STD_EDGES = [(1, n, 2, dh) for dh in (16, 24, 32, 64, 80) for n in (37, 65, 197, 257)]


@pytest.mark.parametrize("b,n,heads,dh", [(2, 17, 2, 8), (1, 65, 3, 16)] + STD_EDGES)
def test_standard_attention(b, n, heads, dh):
    qkv = _n(_rng(4), b, n, 3 * heads * dh)
    ours = ops.standard_attention(_t(qkv), heads)
    _close(ours, j_standard(jnp.asarray(qkv), heads, True))


@pytest.mark.parametrize("heads", [2, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_octic_attention_fused_qkv(heads, bias):
    rng = _rng(5)
    b, n, c8 = 2, 13, 8 * heads
    xs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 4 * c8)]
    w1 = _n(rng, 4, c8, 3 * c8, scale=0.2)
    we = _n(rng, 2 * c8, 6 * c8, scale=0.2)
    bb = _n(rng, 3 * c8) if bias else None
    ours = ops.octic_attention_fused_qkv(
        *map(_t, xs), _t(w1), _t(we), None if bb is None else _t(bb), heads)
    theirs = j_octic_fused(
        *map(jnp.asarray, xs), jnp.asarray(w1), jnp.asarray(we),
        None if bb is None else jnp.asarray(bb), heads)
    assert [tuple(o.shape) for o in ours] == [t.shape for t in theirs]
    for i, (o, t) in enumerate(zip(ours, theirs)):
        _close(o, t, msg=f"output {i}")


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_gelu(rank, bias):
    rng = _rng(6)
    shape = (13, 16) if rank == 2 else (2, 7, 16)
    x = _n(rng, *shape)
    w = _n(rng, 16, 40, scale=0.3)  # flax layout [C, F]
    bb = _n(rng, 40) if bias else None
    ours = ops.dense_gelu(_t(x), _t(w.T), None if bb is None else _t(bb))
    theirs = j_dense_gelu(jnp.asarray(x), jnp.asarray(w), None if bb is None else jnp.asarray(bb))
    _close(ours, theirs)


# K-dense's ragged edges: M not a multiple of the 128-row tile, K of one,
# three and twenty 64-wide blocks, F a multiple of 8 but not of 128
@pytest.mark.parametrize("m,k,bias", [(130, 64, True), (300, 192, False), (130, 1280, True)])
def test_dense_gelu_ragged(m, k, bias):
    rng = _rng(16)
    x = _n(rng, m, k)
    w = _n(rng, k, 264, scale=k ** -0.5)  # flax layout [C, F]
    bb = _n(rng, 264) if bias else None
    ours = ops.dense_gelu(_t(x), _t(w.T), None if bb is None else _t(bb))
    theirs = j_dense_gelu(jnp.asarray(x), jnp.asarray(w), None if bb is None else jnp.asarray(bb))
    _close(ours, theirs)


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_d8_fused(bias):
    rng = _rng(7)
    b, n, c, h = 2, 9, 8, 16
    xs = [_n(rng, b, n, c) for _ in range(4)] + [_n(rng, b, n, 4 * c)]
    w1a, wea = _n(rng, 4, c, h, scale=0.3), _n(rng, 2 * c, 2 * h, scale=0.3)
    w1b, web = _n(rng, 4, h, c, scale=0.3), _n(rng, 2 * h, 2 * c, scale=0.3)
    b1 = _n(rng, h) if bias else None
    b2 = _n(rng, c) if bias else None
    opt = lambda a: None if a is None else _t(a)  # noqa: E731
    ours = ops.mlp_d8_fused(tuple(map(_t, xs)), _t(w1a), _t(wea), opt(b1),
                            _t(w1b), _t(web), opt(b2))
    jopt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    x1 = jnp.asarray(np.stack([x.reshape(b * n, c) for x in xs[:4]]))
    xef = jnp.asarray(xs[4].reshape(b * n, 4 * c))
    y1, yef = j_mlp_fused(x1, xef, jnp.asarray(w1a), jnp.asarray(wea), jopt(b1),
                          jnp.asarray(w1b), jnp.asarray(web), jopt(b2))
    for g in range(4):
        _close(ours[g], np.asarray(y1[g]).reshape(b, n, c), msg=f"slot {g}")
    _close(ours[4], np.asarray(yef).reshape(b, n, 4 * c), msg="E")


def test_kernel_ops_reject_other_devices():
    x = torch.zeros(2, 3, 24, device="meta")
    with pytest.raises(ValueError):
        ops.standard_attention(x, 1)


def test_port_never_imports_jax():
    import os
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import octic_vits_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
