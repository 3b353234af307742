"""Parity of the port's octic attention with the JAX package on the CPU, in
f32, at sequence lengths past the limits the card's whole-head kernels had
(forward 448 tokens at head width 80, backward 320): the composition the
fused qkv + attention runs on the card (route (a): the qkv stored as the wide
qkv, then the attention over it) against the JAX ``octic_attention_fused_qkv``
at N = 449, and the JAX ``octic_attention`` VJP at N = 321. The JAX side runs
its Pallas kernels in interpret mode, as the JAX package's own tests run
them. Inputs come from seeded numpy generators and go to both sides; f32 on
both sides, sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from octic_vits_tpu.ops.pallas_attention import (
    octic_attention as j_octic_attention,
    octic_attention_fused_qkv as j_fused_qkv,
)
from octic_vits_tpu_torch.ops import attention as tattn
from octic_vits_tpu_torch.ops import linear as tlinear

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(ours, theirs, msg=""):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(theirs, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=msg)


def test_route_a_matches_jax_fused_qkv_past_the_forward_limit():
    """B=1, N=449, C=160, 2 heads (dh = 80): the wide qkv store and the
    attention over it give the JAX fused op's six outputs."""
    b, n, c8, heads = 1, 449, 20, 2
    rng = np.random.default_rng(0)
    xs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 4 * c8)]
    w1 = _n(rng, 4, c8, 3 * c8, scale=c8 ** -0.5)
    we = _n(rng, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5)
    bias = _n(rng, 3 * c8, scale=0.1)
    want = j_fused_qkv(*map(jnp.asarray, xs), jnp.asarray(w1), jnp.asarray(we),
                       jnp.asarray(bias), heads, True)
    t = [torch.from_numpy(a) for a in xs]
    qkv = tlinear.linear_d8_qkv_wide_reference(torch.stack(t[:4]), t[4], torch.from_numpy(w1),
                                               torch.from_numpy(we), torch.from_numpy(bias),
                                               heads)
    got = tattn.octic_attention_wide_reference(qkv, heads)
    for i in range(6):
        _close(got[i], want[i], f"out {i}")


def test_octic_attention_vjp_matches_jax_past_the_backward_limit():
    """B=1, N=321, C=160, 2 heads (dh = 80): the plain backward the card's
    streamed K-attn-bwd is held against gives the JAX VJP's six gradients."""
    b, n, c8, heads = 1, 321, 20, 2
    rng = np.random.default_rng(1)
    ones = [_n(rng, b, n, 3 * c8) for _ in range(4)]
    ef = _n(rng, b, n, 12 * c8)
    qs = ones + [ef[..., :6 * c8], ef[..., 6 * c8:]]
    gs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 2 * c8) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: j_octic_attention(*a, heads, True), *map(jnp.asarray, qs))
    want = vjp(tuple(map(jnp.asarray, gs)))
    got = tattn.octic_attention_bwd_reference(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                                    for a in qs),
                                              tuple(map(torch.from_numpy, gs)), heads)
    for i in range(6):
        _close(got[i], want[i], f"grad {i}")
