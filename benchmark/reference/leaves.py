"""The leaves of the comparison: each parameter tensor, except that a fused
qkv projection's weight and bias are three leaves each, the query's, the
key's and the value's (the thirds of their output dimension), as the
architecture has them. The key's bias is nought to rounding under the
softmax; apart from the query's and the value's, the rule on the reference's
gradient can leave it out of the change gaps."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def split(name: str, t: torch.Tensor) -> list:
    if ".qkv." not in name:
        return [(name, t)]
    dim = 0 if name.endswith("qkv.weight") else -1  # Linear weights are [out, in]
    return [(f"{name}:{part}", c) for part, c in zip("qkv", t.chunk(3, dim=dim))]


def leaf_norms(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """name -> float norm of every leaf of the (name, tensor) pairs."""
    pairs = [leaf for name, t in named for leaf in split(name, t)]
    norms = torch._foreach_norm([t for _, t in pairs])
    return {n: float(v) for (n, _), v in zip(pairs, norms)}
