"""The D8-equivariant GELU in plain PyTorch: pointwise exact-erf GELU in
regular-representation coordinates (isotypic -> regular butterfly, GELU,
regular -> isotypic), and its backward. Counterpart of
octic_vits_tpu/ops/gelu_d8.py and of the GELU helpers of
octic_vits_tpu/ops/pallas_gelu.py; it is the plain building block of the
octic MLP's reference and of the backward of ``linear_d8_fused``. The flat-E
slot split of pallas_gelu.py:_split_e_flat is d8.group.unpack_5f_to_8."""

from __future__ import annotations

import math

import torch

from octic_vits_tpu_torch.d8.group import (
    isotypic_to_regular,
    pack_8_to_5,
    pack_8_to_5f,
    regular_to_isotypic,
    unpack_5_to_8,
    unpack_5f_to_8,
)

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


def gelu_d8_bwd(zs: tuple, gs: tuple) -> tuple:
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
