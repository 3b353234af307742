"""The D8-equivariant GELU: pointwise exact-erf GELU in
regular-representation coordinates (isotypic -> regular butterfly, GELU,
regular -> isotypic), and its backward. Counterpart of
octic_vits_tpu/ops/gelu_d8.py and of octic_vits_tpu/ops/pallas_gelu.py.

* :func:`gelu_d8_eager` and :func:`gelu_d8_vjp`: the plain math, the
  building blocks of the octic MLP's reference and of the backward of
  ``linear_d8_fused``;
* :func:`gelu_d8`: the kernel op (pallas_gelu.py:gelu_d8_pallas, the
  ``GeluD8`` of ``use_pallas_gelu``): CPU tensors run
  :func:`gelu_d8_reference`, CUDA tensors launch K-gelu-d8
  (csrc/gelu_d8.cu); it saves only its input, and its backward
  :func:`gelu_d8_bwd` launches the backward kernel.

The flat-E slot split of pallas_gelu.py:_split_e_flat is
d8.group.unpack_5f_to_8."""

from __future__ import annotations

import math

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.d8.group import (
    isotypic_to_regular,
    pack_8_to_5,
    pack_8_to_5f,
    regular_to_isotypic,
    unpack_5_to_8,
    unpack_5f_to_8,
)
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.utils import tracing

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_exact(u: torch.Tensor) -> torch.Tensor:
    """0.5 u (1 + erf(u / sqrt 2)) with the exact erf."""
    return 0.5 * u * (1.0 + torch.erf(u * _INV_SQRT2))


def gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of :func:`gelu_exact`: Phi(u) + u phi(u) (pallas_gelu.py:_gelu_grad)."""
    cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    return cdf + u * (_INV_SQRT2PI * torch.exp(-0.5 * u * u))


def _to_8(xs: tuple) -> tuple:
    return unpack_5f_to_8(xs) if xs[4].ndim == xs[0].ndim else unpack_5_to_8(xs)


def _from_8(xs: tuple, flat_e: bool) -> tuple:
    return pack_8_to_5f(xs) if flat_e else pack_8_to_5(xs)


def gelu_d8_vjp(zs: tuple, gs: tuple) -> tuple:
    """Cotangent of the octic GELU at the input tuple `zs` for the output
    cotangent `gs` (same containers): ``R(gelu'(S z) * (S g))`` with S the
    isotypic -> regular butterfly and R = S^-1 = S^T its inverse, as in
    pallas_linear.py:_bwd_rule and pallas_gelu.py's backward kernel."""
    u = isotypic_to_regular(_to_8(zs))
    v = isotypic_to_regular(_to_8(gs))
    d = regular_to_isotypic(tuple(gelu_grad(a) * b for a, b in zip(u, v)))
    return _from_8(d, zs[4].ndim == zs[0].ndim)


def gelu_d8_eager(xs: tuple) -> tuple:
    """Octic GELU on a 5-tuple (flat-E or ``[..., 2, C/4]`` E)."""
    reg = isotypic_to_regular(_to_8(xs))
    iso = regular_to_isotypic(tuple(gelu_exact(x) for x in reg))
    return _from_8(iso, xs[4].ndim == xs[0].ndim)


def gelu_d8_reference(xs: tuple) -> tuple:
    """Plain version of the kernel: f32 math with the exact erf, one rounding
    to the input dtype (the JAX bf16 kernel's A&S 7.1.27 erf is not copied)."""
    dt = xs[0].dtype
    return tuple(t.to(dt) for t in gelu_d8_eager(tuple(x.float() for x in xs)))


def gelu_d8_bwd_reference(xs: tuple, gs: tuple) -> tuple:
    """Plain version of the backward kernel: :func:`gelu_d8_vjp` in f32,
    rounded to the cotangent's dtype."""
    dt = gs[0].dtype
    return tuple(t.to(dt) for t in gelu_d8_vjp(tuple(x.float() for x in xs),
                                                tuple(g.float() for g in gs)))


def _flat(xs: tuple) -> tuple:
    """The flat-E view of a 5-tuple (``[..., 2, 2c]`` E rows flattened)."""
    return xs if xs[4].ndim == xs[0].ndim else xs[:4] + (xs[4].flatten(-2),)


def _like(ys: tuple, xs: tuple) -> tuple:
    return ys if xs[4].ndim == xs[0].ndim else ys[:4] + (ys[4].unflatten(-1, (2, -1)),)


def gelu_launch(xs: tuple, gs=None) -> tuple:
    """One launch of K-gelu-d8 on CUDA bf16 flat-E tuples: the forward, or
    with the cotangent `gs` the backward. Counts nothing."""
    c = xs[0].shape[-1]
    if c % 8:
        raise ValueError(f"gelu_d8: the slot width c={c} must be a multiple of 8")
    lead = tuple(xs[0].shape[:-1])
    for name, t5 in (("xs", xs), ("gs", gs)):
        if t5 is None:
            continue
        for g in range(4):
            check_kernel_arg(t5[g], f"{name}[{g}]", lead + (c,))
        check_kernel_arg(t5[4], f"{name}[4]", lead + (4 * c,))
    ys = tuple(torch.empty_like(x) for x in xs)
    kernels.launch("ovt_gelu_d8", *xs, *(gs if gs is not None else (None,) * 5), *ys,
                   xs[0].numel() // c, c, int(gs is not None))
    return ys


def gelu_d8_bwd(xs: tuple, gs: tuple) -> tuple:
    """Backward of :func:`gelu_d8` from its saved input `xs` and the
    cotangent `gs`: ``R(gelu'(S x) (S g))``. CPU tensors take
    :func:`gelu_d8_bwd_reference`; CUDA tensors launch the backward kernel."""
    if not on_cuda(tuple(xs) + tuple(gs)):
        return gelu_d8_bwd_reference(xs, gs)
    gelu_d8_bwd.launches += 1
    return _like(gelu_launch(_flat(xs), _flat(gs)), xs)


gelu_d8_bwd.launches = 0


@tracing.op_spans
class _GeluD8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(*xs)  # only the input (pallas_gelu.py:225-227)
        if not on_cuda(xs):
            return gelu_d8_reference(xs)
        gelu_d8.launches += 1
        return _like(gelu_launch(_flat(xs)), xs)

    @staticmethod
    def backward(ctx, *gs):
        return gelu_d8_bwd(ctx.saved_tensors, tuple(g.contiguous() for g in gs))


def gelu_d8(xs: tuple) -> tuple:
    """The octic GELU as one kernel op on a 5-tuple (flat-E or ``[..., 2,
    2c]`` E), differentiable; saves only its input."""
    return _GeluD8.apply(*xs)


gelu_d8.launches = 0
