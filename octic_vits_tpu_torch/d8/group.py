"""D8 group algebra on torch tensors: constants, the isotypic <-> regular
butterflies and the tuple packers.

Counterpart of octic_vits_tpu/d8/group.py. Containers:

* 8-tuple: ``(A1, A2, B1, B2, E11, E21, E12, E22)``, each ``[..., C/8]``;
* 5-tuple: ``(A1, A2, B1, B2, E)`` with ``E`` ``[..., 2, C/4]``
  (row 0 = E11|E12, row 1 = E21|E22);
* flat-E 5-tuple: ``E`` as one ``[..., C/2]`` tensor ``[row0 | row1]`` —
  the layout the port's trunk and kernels carry;
* packed container: the whole octic stream as ONE ``[..., C]`` tensor
  ``[A1 | A2 | B1 | B2 | E row0 | E row1]`` (``packed_carry``). Its slots
  are contiguous column ranges, so the five flat-E views and the ``[..., 8,
  C/8]`` view are free; the kernels read the views through row strides.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

SQRT2 = math.sqrt(2.0)
SQRT2_OVER_2 = SQRT2 / 2.0
SQRT2_OVER_4 = SQRT2 / 4.0


def isotypic_to_regular(xs: Sequence[torch.Tensor]) -> tuple:
    """Isotypic 8-tuple -> regular-representation 8-tuple (butterfly)."""
    a1, a2, b1, b2, e11, e21, e12, e22 = xs
    s0, d0 = a1 + a2, a1 - a2
    s1, d1 = b1 + b2, b1 - b2
    s2, d2 = e11 + e21, e11 - e21
    s3, d3 = e12 + e22, e12 - e22
    u0, v0 = s0 + s1, s0 - s1
    u1, v1 = d0 + d1, d0 - d1
    u2, v2 = s2 + d3, s2 - d3
    u3, v3 = d2 + s3, d2 - s3
    c = SQRT2_OVER_4
    return (
        c * (u0 + u2), c * (v0 + v3), c * (u0 - u2), c * (v0 - v3),
        c * (u1 - u3), c * (v1 - v2), c * (u1 + u3), c * (v1 + v2),
    )


def regular_to_isotypic(xs: Sequence[torch.Tensor]) -> tuple:
    """Regular-representation 8-tuple -> isotypic 8-tuple (butterfly)."""
    x0, x1, x2, x3, x4, x5, x6, x7 = xs
    s0, d0 = x0 + x1, x0 - x1
    s1, d1 = x2 + x3, x2 - x3
    s2, d2 = x4 + x5, x4 - x5
    s3, d3 = x6 + x7, x6 - x7
    u0, v0 = s0 + s1, s1 - s0
    u1, w1 = d0 + d1, d0 - d1
    u2, v2 = s2 + s3, s3 - s2
    u3, w3 = d2 + d3, d2 - d3
    c = SQRT2_OVER_4
    return (
        c * (u0 + u2), c * (u0 - u2), c * (u1 + u3), c * (u1 - u3),
        c * (v2 - v0), c * (w1 + w3), c * (w1 - w3), c * (v2 + v0),
    )


def pack_8_to_5(xs: Sequence[torch.Tensor]) -> tuple:
    """8-tuple -> 5-tuple with E [..., 2, C/4] (row 0 = E11|E12)."""
    e_col0 = torch.stack((xs[4], xs[5]), dim=-2)
    e_col1 = torch.stack((xs[6], xs[7]), dim=-2)
    return (xs[0], xs[1], xs[2], xs[3], torch.cat((e_col0, e_col1), dim=-1))


def unpack_5_to_8(xs: Sequence[torch.Tensor]) -> tuple:
    """Inverse of :func:`pack_8_to_5`."""
    e = xs[4]
    half = e.shape[-1] // 2
    return (
        xs[0], xs[1], xs[2], xs[3],
        e[..., 0, :half], e[..., 1, :half], e[..., 0, half:], e[..., 1, half:],
    )


def unpack_5f_to_8(xs: Sequence[torch.Tensor]) -> tuple:
    """Flat-E 5-tuple -> 8-tuple. ``E = [E11 | E12 | E21 | E22]``."""
    ef = xs[4]
    h = ef.shape[-1] // 4
    return (
        xs[0], xs[1], xs[2], xs[3],
        ef[..., :h], ef[..., 2 * h: 3 * h], ef[..., h: 2 * h], ef[..., 3 * h:],
    )


def pack_8_to_5f(xs: Sequence[torch.Tensor]) -> tuple:
    """8-tuple -> flat-E 5-tuple (inverse of :func:`unpack_5f_to_8`)."""
    return xs[:4] + (torch.cat((xs[4], xs[6], xs[5], xs[7]), dim=-1),)


def pack_5_to_flat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """5-tuple (E ``[..., 2, C/4]`` or flat-E ``[..., C/2]``) -> the packed
    ``[..., C]`` container: one concatenate."""
    e = xs[4] if xs[4].ndim == xs[0].ndim else xs[4].flatten(-2)
    return torch.cat((xs[0], xs[1], xs[2], xs[3], e), dim=-1)


def unpack_flat_to_5(x: torch.Tensor) -> tuple:
    """Packed ``[..., C]`` -> 5-tuple of views with E ``[..., 2, C/4]``."""
    c8 = x.shape[-1] // 8
    return tuple(x[..., g * c8:(g + 1) * c8] for g in range(4)) + (
        x[..., 4 * c8:].unflatten(-1, (2, 2 * c8)),)


def unpack_packed_5f(x: torch.Tensor) -> tuple:
    """Packed ``[..., C]`` -> flat-E 5-tuple of column views (4 x ``[...,
    C/8]`` and E ``[..., C/2] = [row0 | row1]``)."""
    c8 = x.shape[-1] // 8
    return tuple(x[..., g * c8:(g + 1) * c8] for g in range(4)) + (x[..., 4 * c8:],)


def flat_to_break(x: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., C]`` -> the equivariance-break column order of the
    hybrid model, ``cat(unpack_5f_to_8(...))`` = ``[A1|A2|B1|B2| E[0,:C/8] |
    E[1,:C/8] | E[0,C/8:] | E[1,C/8:]]``."""
    v = x.unflatten(-1, (8, x.shape[-1] // 8))
    return v[..., (0, 1, 2, 3, 4, 6, 5, 7), :].flatten(-2)
