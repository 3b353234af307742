"""D8 group algebra on torch tensors: constants, the group's actions on the
regular and isotypic coordinates and on images, the isotypic <-> regular
butterflies and their dense forms, and the tuple packers.

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
from typing import Sequence, Tuple

import torch

SQRT2 = math.sqrt(2.0)
SQRT2_OVER_2 = SQRT2 / 2.0
SQRT2_OVER_4 = SQRT2 / 4.0

#: Group element names. `r` = rot90, `m` = horizontal flip; `mr` means
#: "apply r, then m" (matrix product rho(m) rho(r)).
GROUP_ELEMENTS: Tuple[str, ...] = ("e", "r", "rr", "rrr", "m", "mr", "mrr", "mrrr")

#: Irrep slot names of the isotypic 8-tuple.
IRREPS: Tuple[str, ...] = ("A1", "A2", "B1", "B2", "E11", "E21", "E12", "E22")

#: (rot90 count, mirror?) of each group element acting on images.
_IMAGE_ACTION = {
    "e": (0, False), "r": (1, False), "rr": (2, False), "rrr": (3, False),
    "m": (0, True), "mr": (1, True), "mrr": (2, True), "mrrr": (3, True),
}


def _compose(g1: str, g2: str) -> str:
    """Group multiplication g1 * g2 through the (k, mirror) normal form,
    rho(g) = M^m R^k with R^k M = M R^-k."""
    k1, m1 = _IMAGE_ACTION[g1]
    k2, m2 = _IMAGE_ACTION[g2]
    k, m = ((k2 - k1) % 4, not m1) if m2 else ((k1 + k2) % 4, m1)
    return next(name for name, km in _IMAGE_ACTION.items() if km == (k, m))


#: The 49 products (g1, g2, g1*g2) of non-identity pairs, for property tests.
MULT_TABLE: Tuple[Tuple[str, str, str], ...] = tuple(
    (g1, g2, _compose(g1, g2))
    for g1 in GROUP_ELEMENTS
    for g2 in GROUP_ELEMENTS
    if not (g1 == "e" or g2 == "e")
)

#: Regular-representation action: out[i] = xs[perm[i]]; rotation cycles
#: 0..3 and 4..7, the mirror swaps the halves.
_REG_PERM_R = (1, 2, 3, 0, 7, 4, 5, 6)
_REG_PERM_M = (4, 5, 6, 7, 0, 1, 2, 3)


def _signed_perm_compose(p1, s1, p2, s2):
    """(p1, s1) after (p2, s2): z[i] = s1[i] y[p1[i]], y[j] = s2[j] x[p2[j]]."""
    perm = tuple(p2[p1[i]] for i in range(8))
    sign = tuple(s1[i] * s2[p1[i]] for i in range(8))
    return perm, sign


def _build_signed_perms(gen_r, gen_m):
    perms = {"e": (tuple(range(8)), (1,) * 8), "r": gen_r, "m": gen_m}
    perms["rr"] = _signed_perm_compose(*gen_r, *gen_r)
    perms["rrr"] = _signed_perm_compose(*perms["rr"], *gen_r)
    for k, src in (("mr", "r"), ("mrr", "rr"), ("mrrr", "rrr")):
        perms[k] = _signed_perm_compose(*gen_m, *perms[src])
    return perms


#: Isotypic action, a signed permutation per element: A1 fixed, A2 flips
#: under m, B1 under r, B2 under both, the E columns (E11, E21), (E12, E22)
#: rotate and reflect as the 2-d irrep. Rotation: (A1, A2, -B1, -B2, -E21,
#: E11, -E22, E12).
_ISO_SIGNED = _build_signed_perms(
    gen_r=((0, 1, 2, 3, 5, 4, 7, 6), (1, 1, -1, -1, -1, 1, -1, 1)),
    gen_m=((0, 1, 2, 3, 4, 5, 6, 7), (1, -1, 1, -1, -1, 1, -1, 1)),
)

_REG_SIGNED = _build_signed_perms(
    gen_r=(_REG_PERM_R, (1,) * 8),
    gen_m=(_REG_PERM_M, (1,) * 8),
)


def regular_group_action(g: str, xs: Sequence[torch.Tensor]) -> tuple:
    """Apply g to an 8-tuple in regular-representation coordinates."""
    perm, _ = _REG_SIGNED[g]
    return tuple(xs[perm[i]] for i in range(8))


def isotypic_group_action(g: str, xs: Sequence[torch.Tensor]) -> tuple:
    """Apply g to an 8-tuple in isotypic coordinates (a signed permutation)."""
    perm, sign = _ISO_SIGNED[g]
    return tuple(xs[perm[i]] if sign[i] > 0 else -xs[perm[i]] for i in range(8))


def image_space_group_action(g: str, img: torch.Tensor) -> torch.Tensor:
    """Apply g to an image-like tensor over its last two axes (H, W)."""
    k, mirror = _IMAGE_ACTION[g]
    out = torch.rot90(img, k, dims=(-2, -1)) if k else img
    return torch.flip(out, dims=(-1,)) if mirror else out


def spatial_and_isotypic_group_action(g: str, xs: Sequence[torch.Tensor]) -> tuple:
    """Apply g to the token grid and the isotypic channels together; each
    entry of `xs` is ``[B, L, C]`` with L = H*W a square grid."""
    b, l, c = xs[0].shape
    h = math.isqrt(l)
    if h * h != l:
        raise ValueError("token count must be a square grid")

    def spatial(x):
        grid = image_space_group_action(g, x.reshape(b, h, h, c).movedim(-1, 1))
        return grid.movedim(1, -1).reshape(b, l, c)

    return isotypic_group_action(g, tuple(spatial(x) for x in xs))


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


def _iso_to_reg_matrix(dtype: torch.dtype, device=None) -> torch.Tensor:
    """The orthogonal 8 x 8 change of basis of :func:`isotypic_to_regular`:
    column i is the butterfly of the i-th basis vector (built in f64)."""
    basis = torch.eye(8, dtype=torch.float64)
    cols = [torch.stack(isotypic_to_regular(tuple(basis[i]))) for i in range(8)]
    return torch.stack(cols, dim=1).to(device=device, dtype=dtype)


def isotypic_to_regular_dense(xs: Sequence[torch.Tensor]) -> tuple:
    """The dense-matrix form of :func:`isotypic_to_regular` (its parity oracle)."""
    mat = _iso_to_reg_matrix(xs[0].dtype, xs[0].device)
    out = torch.tensordot(mat, torch.stack(list(xs)), dims=([1], [0]))
    return tuple(out[i] for i in range(8))


def regular_to_isotypic_dense(xs: Sequence[torch.Tensor]) -> tuple:
    """The dense-matrix form of :func:`regular_to_isotypic` (the change of
    basis is orthogonal: M^-1 = M^T)."""
    mat = _iso_to_reg_matrix(xs[0].dtype, xs[0].device).T
    out = torch.tensordot(mat, torch.stack(list(xs)), dims=([1], [0]))
    return tuple(out[i] for i in range(8))


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
