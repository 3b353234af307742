"""D8 invariantization at the invariant-early break: the equivariant 5-tuple
-> invariant features (counterpart of octic_vits_tpu/layers/invariants.py).

Only :class:`PowerSpectrumInvariant`, the one the production "inv-early"
models use, is ported; the six other kinds of the JAX table raise.
"""

from __future__ import annotations

import torch
from torch import nn


class PowerSpectrumInvariant(nn.Module):
    """``cat(A1, |A2|, |B1|, |B2|, ||E||_2 over the two rows)`` -> ``6C/8``
    features, from a 5-tuple whose E is ``[..., 2, C/4]`` (invariants.py:29-44).
    At an E column that is exactly zero, ``torch.linalg.vector_norm`` has
    gradient 0 where ``jnp.linalg.norm`` gives NaN."""

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


#: invariant_kind -> module; the JAX table's other kinds are not ported yet
INVARIANTS = {"power_spectrum": PowerSpectrumInvariant}


def make_invariant(kind: str, dim: int) -> nn.Module:
    if kind not in INVARIANTS:
        raise NotImplementedError(f"invariant_kind {kind!r} is not ported; ported: "
                                  f"{sorted(INVARIANTS)}")
    return INVARIANTS[kind](dim)
