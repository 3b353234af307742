"""Parity of the port's attention backward with the JAX package's VJP on the
CPU, in f32, at the token counts and head widths that bound K-attn-bwd's
launch plan (ops/attention.py:attention_bwd_sm90_plan): N = 1, a token count
below a tile, one tile exactly and one past it, the SSL global crop, the
ViT-H/14 count, the old whole-head limits and a long sequence; dh from 16 to
128. The plain backwards (``standard_attention_bwd_reference``,
``octic_attention_bwd_reference``) are what the card's kernel is held against
(tests/test_torch_port_cuda.py, chip_smoke.py P26). The JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests run them.
Inputs come from seeded numpy generators and go to both sides; f32 on both
sides, sums in another order, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.ops.pallas_attention import (
    octic_attention as j_octic_attention,
    standard_attention as j_standard_attention,
)
from octic_vits_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(ours, theirs, msg=""):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(theirs, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=msg)


@pytest.mark.parametrize("n,dh", [(1, 16), (37, 24), (64, 40), (65, 64), (197, 80),
                                  (257, 120), (321, 128), (385, 80), (1025, 16),
                                  (1025, 80)])
def test_standard_attention_vjp_at_the_plan_edges(n, dh):
    heads = 2
    rng = np.random.default_rng(n * 131 + dh)
    qkv, g = _n(rng, 1, n, 3 * heads * dh), _n(rng, 1, n, heads * dh)
    _, vjp = jax.vjp(lambda x: j_standard_attention(x, heads, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    got = tattn.standard_attention_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(g),
                                                 heads)
    _close(got, want)


@pytest.mark.parametrize("n,d1", [(1, 2), (65, 5), (257, 8), (385, 10), (64, 16)])
def test_octic_attention_vjp_at_the_plan_edges(n, d1):
    heads = 2
    c8 = heads * d1
    rng = np.random.default_rng(n * 17 + d1)
    ones = [_n(rng, 1, n, 3 * c8) for _ in range(4)]
    ef = _n(rng, 1, n, 12 * c8)
    qs = ones + [ef[..., :6 * c8], ef[..., 6 * c8:]]
    gs = [_n(rng, 1, n, c8) for _ in range(4)] + [_n(rng, 1, n, 2 * c8) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: j_octic_attention(*a, heads, True), *map(jnp.asarray, qs))
    want = vjp(tuple(map(jnp.asarray, gs)))
    got = tattn.octic_attention_bwd_reference(
        tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in qs),
        tuple(map(torch.from_numpy, gs)), heads)
    for i in range(6):
        _close(got[i], want[i], f"grad {i}")
