"""The octic MLP residual branch as one op (counterpart of
octic_vits_tpu/ops/pallas_mlp_branch.py, the ``fuse_mlp_branch`` block):

    out = x + ls * fc2(gelu_d8(fc1(ln_d8(x) * alpha + beta)))

``params`` is the JAX 11-tuple (pallas_mlp_branch.py:32-36)::

    (norm_alpha_1d [4, c], norm_alpha_e [2c], norm_beta [c],
     fc1_w1 [4, c, h], fc1_we [2c, 2h], fc1_b [h],
     fc2_w1 [4, h, c], fc2_we [2h, 2c], fc2_b [c],
     ls_1d [4, c], ls_e [2c])

CPU tensors run :func:`mlp_branch_d8_reference`; CUDA tensors compose three
hand-written launches: K-ln-d8 (the LN with its affine), K-lin-d8 (fc1 with
the D8-GELU epilogue) and K-lin-d8 (fc2 with the LayerScale + residual
epilogue). The bf16 hidden round-trips HBM between the two linears (the TPU
kernel keeps it in VMEM; one launch that keeps it on chip is ROADMAP perf
work). The backward is autodiff of :func:`mlp_branch_eager`, as in JAX
(pallas_mlp_branch.py:278-281); the op saves ``(xs, params)``.

Rounding points on the card: the normed input, the hidden after the GELU
and the output are bf16; everything between is f32. The JAX bf16 kernel
rounds the fc1 pre-activation to bf16 before the GELU
(pallas_mlp_branch.py:101-106) instead; the card tolerance covers that.
"""

from __future__ import annotations

import torch

from octic_vits_tpu_torch.ops._dispatch import on_cuda
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_d8_eager
from octic_vits_tpu_torch.ops.linear import (
    _lse_full,
    lin_d8_launch,
    linear_d8,
    linear_d8_fused_reference,
)
from octic_vits_tpu_torch.ops.ln_d8 import ln_affine_d8_reference, ln_fwd_launch
from octic_vits_tpu_torch.utils import tracing


def _norm_affine(params: tuple) -> tuple:
    """alpha [4, c], alpha_ef [1, 4c], beta [1, c] of the LN op from the
    11-tuple."""
    na, ne, nb = params[:3]
    return na, _lse_full(ne)[None], nb[None]


def mlp_branch_eager(xs: tuple, params: tuple, eps: float = 1e-5) -> tuple:
    """The composite in the inputs' dtype (pallas_mlp_branch.py:mlp_branch_eager
    on the flat-E tuple), differentiable by autograd: the backward's rule."""
    from octic_vits_tpu_torch.layers.d8_layers import layer_norm_d8_stats

    na, ne, nb, w1a, wea, b1, w1b, web, b2, ls1, lse = params
    n = layer_norm_d8_stats(xs, eps)
    n = (n[0] * na[0] + nb, n[1] * na[1], n[2] * na[2], n[3] * na[3], n[4] * _lse_full(ne))
    h = gelu_d8_eager(linear_d8(n, w1a, wea, b1))
    y = linear_d8(h, w1b, web, b2)
    return tuple(xs[g] + ls1[g] * y[g] for g in range(4)) + (xs[4] + _lse_full(lse) * y[4],)


def mlp_branch_d8_reference(xs: tuple, params: tuple, eps: float = 1e-5) -> tuple:
    """Plain version of the card's three launches: each the plain version of
    its kernel (f32 math, rounded to the input dtype at its output)."""
    na, ne, nb, w1a, wea, b1, w1b, web, b2, ls1, lse = params
    n = ln_affine_d8_reference(xs, *_norm_affine(params), eps)
    h = linear_d8_fused_reference(n, w1a, wea, b1, fuse_gelu=True)
    return linear_d8_fused_reference(h, w1b, web, b2, layerscale=(ls1, lse), residual=xs)


@tracing.op_spans
class _MlpBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eps, n_x, *tensors):
        xs, params = tensors[:n_x], tensors[n_x:]
        ctx.save_for_backward(*tensors)  # (xs, params), as the JAX rule
        ctx.eps, ctx.n_x = eps, n_x
        if not on_cuda(tensors):
            return mlp_branch_d8_reference(xs, params, eps)
        na, ne, nb, w1a, wea, b1, w1b, web, b2, ls1, lse = params
        mlp_branch_d8.launches += 1
        n = ln_fwd_launch(xs, *_norm_affine(params), eps)
        h = lin_d8_launch(n, w1a, wea, b1, gelu=True)
        return lin_d8_launch(h, w1b, web, b2, gelu=False, layerscale=(ls1, lse), residual=xs)

    @staticmethod
    def backward(ctx, *gs):
        leaves = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = mlp_branch_eager(leaves[:ctx.n_x], leaves[ctx.n_x:], ctx.eps)
        grads = torch.autograd.grad(out, leaves, gs, allow_unused=True)
        return (None, None) + tuple(grads)


def mlp_branch_d8(xs: tuple, params: tuple, eps: float = 1e-5) -> tuple:
    """The fused octic MLP residual branch on the flat-E tuple `xs` with the
    11-tuple `params` (module docstring). Returns the new 5-tuple."""
    return _MlpBranch.apply(eps, len(xs), *xs, *params)


mlp_branch_d8.launches = 0
