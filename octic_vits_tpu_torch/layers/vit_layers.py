"""Standard ViT layers (eval-mode forward) for the standard half of the
hybrid model and for the standard comparator. Counterpart of the
``use_pallas_*`` paths of octic_vits_tpu/layers/vit_layers.py: attention
through :func:`standard_attention`, the MLP's fc1 through
:func:`dense_gelu`; qkv, proj, fc2 and the patch embed are plain
``nn.Linear`` products. Inputs are NHWC images / ``[B, N, C]`` tokens."""

from __future__ import annotations

import torch
from torch import nn

from octic_vits_tpu_torch.layers.d8_layers import _patchify
from octic_vits_tpu_torch.ops.attention import standard_attention
from octic_vits_tpu_torch.ops.dense import dense_gelu


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(in_features, hidden_features, **kw)
        self.fc2 = nn.Linear(hidden_features, in_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(dense_gelu(x, self.fc1.weight, self.fc1.bias))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(standard_attention(self.qkv(x), self.num_heads))


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (``gamma_1``, ``gamma_2``),
    the DeiT III block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, layerscale_init: float = 1e-4, norm_eps: float = 1e-6,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layerscale_init = layerscale_init
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias, **kw)
        self.gamma_1 = nn.Parameter(torch.empty(dim, **kw))
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)
        self.gamma_2 = nn.Parameter(torch.empty(dim, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma_1, self.layerscale_init)
        nn.init.constant_(self.gamma_2, self.layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Patch embed of RGB images as patchify + one matmul (stride == kernel)."""

    def __init__(self, patch_size: int, embed_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(patch_size * patch_size * 3, embed_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        out = self.proj(_patchify(x.to(self.proj.weight.dtype), p))
        return out.reshape(b, (h // p) * (w // p), -1)
