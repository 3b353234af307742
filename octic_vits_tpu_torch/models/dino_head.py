"""DINO projection head (counterpart of octic_vits_tpu/models/dino_head.py):
an MLP, L2 normalisation, and a weight-normalised prototype layer (65536
prototypes in the paper's configurations). Parameter names follow the flax
tree: ``mlp_0`` .. ``mlp_{n-1}`` (Dense, here :class:`Linear`) and
``last_layer.v`` ``[in, out]`` / ``last_layer.g`` ``[out]``. The prototype
layer is one plain ``torch.matmul``, as the JAX head leaves it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_
from octic_vits_tpu_torch.layers.vit_layers import Linear


class WeightNormDense(nn.Module):
    """Dense layer with weight normalisation, ``W = g * V / ||V||`` with the
    norm over each output column; ``g`` starts at 1 and is trained."""

    def __init__(self, in_features: int, features: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.v = nn.Parameter(torch.empty(in_features, features, **kw))
        self.g = nn.Parameter(torch.empty(features, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.v, 0.02, generator)
        nn.init.ones_(self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(self.v.square().sum(0, keepdim=True) + 1e-12)
        w = self.v / norm * self.g[None, :]
        return torch.matmul(x, w.to(x.dtype))


class DINOHead(nn.Module):
    """``nlayers`` Dense layers (exact GELU between them) to the bottleneck,
    L2 normalisation, then the weight-normalised prototypes. Runs in the
    dtype of its input (parameters cast at use)."""

    def __init__(self, in_dim: int, out_dim: int = 65536, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3, use_bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (n - 1) + [bottleneck_dim]
        self.n = n
        for i in range(n):
            self.add_module(f"mlp_{i}", Linear(dims[i], dims[i + 1], bias=use_bias, **kw))
        self.last_layer = WeightNormDense(bottleneck_dim, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"mlp_{i}")(x)
            if i < self.n - 1:
                x = F.gelu(x)
        eps = 1e-6 if x.dtype == torch.float16 else 1e-12
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
        return self.last_layer(x)
