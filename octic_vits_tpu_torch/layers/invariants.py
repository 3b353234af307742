"""D8 invariantization at the invariant-early break: the equivariant 5-tuple
-> invariant features (counterpart of octic_vits_tpu/layers/invariants.py),
all seven kinds of the JAX table, and :class:`InvariantHead`.

Each kind takes the 5-tuple ``(A1, A2, B1, B2, E)`` with E ``[..., 2, C/4]``
(row 0 = E11|E12, row 1 = E21|E22), the layout the octic model's break
hands over from the flat-E carry and from the packed container; the kinds
that work slot by slot split E into (x4, x5, x6, x7) = (E11, E21, E12, E22)
as JAX's ``_split_e`` does. The models use ``power_spectrum``; the other
kinds are the reference's ablations. Plain torch, as JAX computes them
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.d8.group import unpack_5_to_8


def _split_e(e: torch.Tensor) -> tuple:
    """E ``[..., 2, C/4]`` -> (x4, x5, x6, x7), each ``[..., C/8]``."""
    half = e.shape[-1] // 2
    return e[..., 0, :half], e[..., 1, :half], e[..., 0, half:], e[..., 1, half:]


class PowerSpectrumInvariant(nn.Module):
    """``cat(A1, |A2|, |B1|, |B2|, ||E||_2 over the two rows)`` -> ``6C/8``
    features (invariants.py:29-44). At an E column that is exactly zero,
    ``torch.linalg.vector_norm`` has gradient 0 where ``jnp.linalg.norm``
    gives NaN."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def output_dim(self) -> int:
        return 6 * self.dim // 8

    def forward(self, xs: tuple) -> torch.Tensor:
        a1, a2, b1, b2, e = xs
        e_norm = torch.linalg.vector_norm(e, dim=-2)
        return torch.cat((a1, a2.abs(), b1.abs(), b2.abs(), e_norm), dim=-1)


class NonInvariant(nn.Module):
    """``|x|`` of all eight slots, concatenated: C features, an abs baseline
    that is not invariant (invariants.py:47-59)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def output_dim(self) -> int:
        return self.dim

    def forward(self, xs: tuple) -> torch.Tensor:
        return torch.cat([p.abs() for p in unpack_5_to_8(xs)], dim=-1)


class LinearInvariant(nn.Module):
    """``|A1|``: C/8 features (invariants.py:62-72)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def output_dim(self) -> int:
        return self.dim // 8

    def forward(self, xs: tuple) -> torch.Tensor:
        return xs[0].abs()


class PolynomialInvariant(nn.Module):
    """The invariant polynomials of degree <= 4: 32C/8 features
    (invariants.py:75-124)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def output_dim(self) -> int:
        return 32 * self.dim // 8

    def forward(self, xs: tuple) -> torch.Tensor:
        x0, x1, x2, x3, e = xs
        x4, x5, x6, x7 = _split_e(e)
        return torch.cat((
            x0,
            x6**2 + x7**2,
            x4 * x6 + x5 * x7,
            x4**2 + x5**2,
            x3**2,
            x2**2,
            x1**2,
            x3 * x6 * x7,
            x3 * x5 * x6 + x3 * x4 * x7,
            x3 * x4 * x5,
            x2 * x6**2 - x2 * x7**2,
            x2 * x4 * x6 - x2 * x5 * x7,
            x2 * x4**2 - x2 * x5**2,
            x1 * x5 * x6 - x1 * x4 * x7,
            x1 * x2 * x3,
            x6**4 + x7**4,
            x4 * x6**3 + x5 * x7**3,
            x4**2 * x6**2 + x5**2 * x7**2,
            x4**3 * x6 + x5**3 * x7,
            x4**4 + x5**4,
            x2 * x3 * x5 * x6 - x2 * x3 * x4 * x7,
            x1 * x3 * x6**2 - x1 * x3 * x7**2,
            x1 * x3 * x4 * x6 - x1 * x3 * x5 * x7,
            x1 * x3 * x4**2 - x1 * x3 * x5**2,
            x1 * x2 * x6 * x7,
            x1 * x2 * x5 * x6 + x1 * x2 * x4 * x7,
            x1 * x2 * x4 * x5,
            x1 * x6**3 * x7 - x1 * x6 * x7**3,
            x1 * x5 * x6**3 - x1 * x4 * x7**3,
            x1 * x4 * x5 * x6**2 - x1 * x4 * x5 * x7**2,
            x1 * x4**2 * x5 * x6 - x1 * x4 * x5**2 * x7,
            x1 * x4**3 * x5 - x1 * x4 * x5**3,
        ), dim=-1)


class ThirdOrderInvariant(nn.Module):
    """The invariants of degree <= 3: 15C/8 features (invariants.py:127-159)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def output_dim(self) -> int:
        return 15 * self.dim // 8

    def forward(self, xs: tuple) -> torch.Tensor:
        x0, x1, x2, x3, e = xs
        x4, x5, x6, x7 = _split_e(e)
        return torch.cat((
            x0**3,
            x0 * (x6**2 + x7**2),
            x0 * (x4 * x6 + x5 * x7),
            x0 * (x4**2 + x5**2),
            x0 * x3**2,
            x0 * x2**2,
            x0 * x1**2,
            x3 * x6 * x7,
            x3 * x5 * x6 + x3 * x4 * x7,
            x3 * x4 * x5,
            x2 * x6**2 - x2 * x7**2,
            x2 * x4 * x6 - x2 * x5 * x7,
            x2 * x4**2 - x2 * x5**2,
            x1 * x5 * x6 - x1 * x4 * x7,
            x1 * x2 * x3,
        ), dim=-1)


# The 8 x 8 isotypic action of the rotation and the mirror, columns ordered A1
# A2 B1 B2 E11 E21 E12 E22 (invariants.py:162-177)
_ROT = (
    (1.0, 0, 0, 0, 0, 0, 0, 0),
    (0.0, 1, 0, 0, 0, 0, 0, 0),
    (0.0, 0, -1, 0, 0, 0, 0, 0),
    (0.0, 0, 0, -1, 0, 0, 0, 0),
    (0.0, 0, 0, 0, 0, -1, 0, 0),
    (0.0, 0, 0, 0, 1, 0, 0, 0),
    (0.0, 0, 0, 0, 0, 0, 0, -1),
    (0.0, 0, 0, 0, 0, 0, 1, 0),
)
_REFL = (1.0, -1, 1, -1, -1, 1, -1, 1)


def orbit_matrices(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``[8, 8, 8]``: the isotypic action of e, r, r², r³, m, mr, mr², mr³
    (invariants.py:_orbit_matrices), built on `device`."""
    r = torch.tensor(_ROT, dtype=dtype, device=device)
    m = torch.diag(torch.tensor(_REFL, dtype=dtype, device=device))
    rr = r @ r
    rrr = rr @ r
    return torch.stack((torch.eye(8, dtype=dtype, device=device), r, rr, rrr,
                        m, m @ r, m @ rr, m @ rrr))


def _normalized_normal_(p: torch.Tensor, dims: tuple, generator: torch.Generator) -> None:
    """A normal draw (f32, from `generator`) divided by its L2 norm over
    `dims`, copied into `p`."""
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.normal_(tmp, generator=generator)
    tmp = tmp / torch.linalg.vector_norm(tmp, dim=dims, keepdim=True)
    with torch.no_grad():
        p.copy_(tmp)


class MaxFilteringInvariant(nn.Module):
    """The max over the 8-element orbit of the inner products with learned
    reference directions (invariants.py:197-234): ``references [n_ref, C/8,
    8]`` (``n_ref`` = `num_references` or 2C), drawn normalised per
    reference. With `global_avg` the input is one token an image (``[B,
    C/8]`` slots). The orbit max is ``torch.amax``, whose gradient is shared
    among tied maxima as JAX's ``jnp.max`` shares it (``torch.max`` with a
    dim sends it to one)."""

    def __init__(self, dim: int, num_references: Optional[int] = None,
                 global_avg: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.dim = dim
        self.global_avg = global_avg
        self.references = nn.Parameter(torch.empty(num_references or 2 * dim, dim // 8, 8,
                                                   device=device, dtype=dtype))

    @property
    def output_dim(self) -> int:
        return self.references.shape[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normalized_normal_(self.references, (1, 2), generator)

    def forward(self, xs: tuple) -> torch.Tensor:
        x0, x1, x2, x3, e = xs
        x = torch.cat((x0, x1, x2, x3) + _split_e(e), dim=-1)  # (slot, channel) order
        refs = self.references.to(x.dtype)
        acted = torch.einsum("gij,dcj->gdic", orbit_matrices(x.dtype, x.device), refs)
        expanded = acted.reshape(8, refs.shape[0], -1)
        if self.global_avg:
            products = torch.einsum("kdc,bc->bkd", expanded, x)
        else:
            products = torch.einsum("kdc,bnc->bnkd", expanded, x)
        return torch.amax(products, dim=-2)


class CanonizationInvariant(nn.Module):
    """Orbit canonicalisation (invariants.py:237-273): the group element whose
    action on the features has the largest inner product with a learned
    ``reference [C]`` (drawn normalised), then the features acted on by it.
    ``argmax`` takes the first maximum, in both frameworks. With
    `global_avg` the input is one token an image."""

    def __init__(self, dim: int, global_avg: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.dim = dim
        self.global_avg = global_avg
        self.reference = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))

    @property
    def output_dim(self) -> int:
        return self.dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normalized_normal_(self.reference, (0,), generator)

    def forward(self, xs: tuple) -> torch.Tensor:
        x0, x1, x2, x3, e = xs
        x = torch.stack((x0, x1, x2, x3) + _split_e(e), dim=-1)  # [B, N, C/8, 8]
        if self.global_avg:
            x = x[:, None]
        acted = torch.einsum("gij,bncj->bngic", orbit_matrices(x.dtype, x.device), x)
        b, n = acted.shape[:2]
        expanded = acted.reshape(b, n, 8, -1)
        products = torch.einsum("c,bnkc->bnk", self.reference.to(x.dtype), expanded)
        idx = products.argmax(-1)
        out = torch.take_along_dim(expanded, idx[..., None, None], dim=2)[..., 0, :]
        return out[:, 0] if self.global_avg else out


class InvariantHead(nn.Module):
    """The projection head of fully octic networks (invariants.py:276-294):
    (LayerNorm, eps 1e-6) -> Linear -> GELU -> Linear to the logits (none
    with ``num_classes = 0``). Its modules carry the flax names."""

    def __init__(self, in_features: int, hidden_dim: int, num_classes: int,
                 use_norm: bool = False, *, device=None, dtype=None):
        super().__init__()
        from octic_vits_tpu_torch.layers.vit_layers import LayerNorm, Linear

        kw = dict(device=device, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(in_features, eps=1e-6, **kw) if use_norm else None
        self.Dense_0 = Linear(in_features, hidden_dim, **kw)
        self.Dense_1 = Linear(hidden_dim, num_classes, **kw) if num_classes > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        x = F.gelu(self.Dense_0(x))
        return x if self.Dense_1 is None else self.Dense_1(x)


#: invariant_kind -> module (invariants.py:297-305)
INVARIANTS = {
    "power_spectrum": PowerSpectrumInvariant,
    "non_invariant": NonInvariant,
    "linear": LinearInvariant,
    "polynomial": PolynomialInvariant,
    "third_order": ThirdOrderInvariant,
    "max_filtering": MaxFilteringInvariant,
    "canonization": CanonizationInvariant,
}

# the kinds with learned parameters, which take device and dtype
_LEARNED = ("max_filtering", "canonization")


def make_invariant(kind: str, dim: int, *, device=None, dtype=None, **options) -> nn.Module:
    """The invariant `kind` of the JAX table for embed dim `dim`; `options`
    go to its constructor (``num_references``, ``global_avg``)."""
    if kind not in INVARIANTS:
        raise ValueError(f"unknown invariant_kind {kind!r}; known: {sorted(INVARIANTS)}")
    if kind in _LEARNED:
        options.update(device=device, dtype=dtype)
    return INVARIANTS[kind](dim, **options)
