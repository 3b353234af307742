"""The D8-equivariant GELU in plain PyTorch: pointwise exact-erf GELU in
regular-representation coordinates (isotypic -> regular butterfly, GELU,
regular -> isotypic). Counterpart of octic_vits_tpu/ops/gelu_d8.py and of
the GELU helper of octic_vits_tpu/ops/pallas_gelu.py; it is the plain
building block of the octic MLP's reference. The flat-E slot split of
pallas_gelu.py:_split_e_flat is d8.group.unpack_5f_to_8."""

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


def gelu_exact(u: torch.Tensor) -> torch.Tensor:
    """0.5 u (1 + erf(u / sqrt 2)) with the exact erf."""
    return 0.5 * u * (1.0 + torch.erf(u * _INV_SQRT2))


def gelu_d8_eager(xs: tuple) -> tuple:
    """Octic GELU on a 5-tuple (flat-E or ``[..., 2, C/4]`` E)."""
    flat_e = xs[4].ndim == xs[0].ndim
    reg = isotypic_to_regular(unpack_5f_to_8(xs) if flat_e else unpack_5_to_8(xs))
    iso = regular_to_isotypic(tuple(gelu_exact(x) for x in reg))
    return pack_8_to_5f(iso) if flat_e else pack_8_to_5(iso)
