"""Seeded random initialisation of a port model from a ``torch.Generator``.

The distributions follow the flax initialisers (truncated normal 0.02 for
products, LayerScale constants, unit norms); the numbers differ from JAX's,
which draw from another generator. The generator must live on the
parameters' device."""

from __future__ import annotations

import torch
from torch import nn

from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `root`: modules of this package through their
    ``reset_parameters(generator)``, ``nn.Linear`` and ``nn.LayerNorm`` as
    flax's Dense and LayerNorm start."""
    for m in root.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_parameters") and type(m).__module__.startswith(
            "octic_vits_tpu_torch."
        ):
            m.reset_parameters(generator)
