"""Seeded weights in the program's parameter layout (its parameter names and
shapes), made on the device in one draw: one normal draw of every parameter
at once from a ``torch.Generator`` on the device, cut into the parameters,
each scaled and shifted by the first rule of the configuration's weight
scheme (``weight_schemes/<name>.json``: ``[pattern, mean, std]``) whose
pattern its name matches. The same seed on the same device gives the same
values, so the reference draws them again rather than reading the program's.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

HERE = Path(__file__).resolve().parent


def load_scheme(name: str) -> list:
    rules = json.loads((HERE / "weight_schemes" / f"{name}.json").read_text())["rules"]
    return [(re.compile(pat), float(mean), float(std)) for pat, mean, std in rules]


def rule_of(name: str, rules: list) -> Tuple[float, float]:
    for pat, mean, std in rules:
        if pat.search(name):
            return mean, std
    raise KeyError(f"no weight rule matches parameter {name!r}")


def seeded(shapes: Iterable[Tuple[str, tuple]], scheme: str, seed: int,
           device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` for each (name, shape) of `shapes`,
    in that order; the values are views into one buffer."""
    rules = load_scheme(scheme)
    shapes = [(n, tuple(s)) for n, s in shapes]
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, start = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        mean, std = rule_of(name, rules)
        view = flat[start:start + size].view(shape)
        view.mul_(std).add_(mean)
        out[name] = view
        start += size
    return out


def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy `values` into the module's parameters (each cast to its dtype)."""
    params = dict(module.named_parameters())
    if set(params) != set(values):
        raise KeyError(f"weights and module disagree: {sorted(set(params) ^ set(values))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(values[name])


def shapes_of(module: torch.nn.Module) -> list:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]
