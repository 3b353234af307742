"""Standard ViT layers for the standard half of the hybrid model and for the
standard comparator. Counterpart of the ``use_pallas_*`` paths of
octic_vits_tpu/layers/vit_layers.py: attention through
:func:`standard_attention`, the MLP's fc1 through :func:`dense_gelu` (both
differentiable); qkv, proj, fc2 and the patch embed are plain linear
products. Parameters are cast to the activations' dtype at use (f32
parameters under bf16 compute in training). Inputs are NHWC images /
``[B, N, C]`` tokens."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.layers.common import DropPathMask, cast, remat
from octic_vits_tpu_torch.layers.d8_layers import _patchify
from octic_vits_tpu_torch.ops.attention import standard_attention
from octic_vits_tpu_torch.ops.dense import dense_gelu


class Linear(nn.Linear):
    """``nn.Linear`` whose parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose parameters are cast to the input's dtype. Its
    statistics are f32, as flax LayerNorm's: torch's layer_norm kernels
    accumulate bf16 inputs in f32, so the activations are not widened."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, cast(self.weight, x.dtype),
                            cast(self.bias, x.dtype), self.eps)


def drop_path(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample stochastic depth with a mask from
    :func:`~octic_vits_tpu_torch.layers.common.drop_path_mask`; ``None``
    is the identity (vit_layers.py:drop_path)."""
    return x if mask is None else x * mask


class DropPath(DropPathMask):
    """Drop path of the standard block: one mask on one tensor."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return drop_path(x, mask)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(in_features, hidden_features, bias=bias, **kw)
        self.fc2 = Linear(hidden_features, in_features, bias=bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return self.fc2(dense_gelu(x, self.fc1.weight.to(dt), cast(self.fc1.bias, dt)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False, proj_bias: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, bias=proj_bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(standard_attention(self.qkv(x), self.num_heads))


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (``gamma_1``, ``gamma_2``)
    and drop path, the DeiT III block. ``forward(x, masks, remat_block)`` as
    d8_layers.BlockD8: with `remat_block` the norm1 + qkv and the proj ... MLP
    halves are rematerialized around the attention kernel."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, layerscale_init: float = 1e-4, norm_eps: float = 1e-6,
                 drop_path: float = 0.0, proj_bias: bool = True, ffn_bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layerscale_init = layerscale_init
        self.norm1 = LayerNorm(dim, eps=norm_eps, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, **kw)
        self.gamma_1 = nn.Parameter(torch.empty(dim, **kw))
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), ffn_bias, **kw)
        self.gamma_2 = nn.Parameter(torch.empty(dim, **kw))
        self.drop_path2 = DropPath(drop_path)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma_1, self.layerscale_init)
        nn.init.constant_(self.gamma_2, self.layerscale_init)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator], *, device=None,
                   dtype=None) -> tuple:
        kw = dict(device=device, dtype=dtype)
        return (self.drop_path1.draw(batch, generator, **kw),
                self.drop_path2.draw(batch, generator, **kw))

    def _attn_in(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn.qkv(self.norm1(x))

    def _attn_out(self, x, a, m1, m2) -> torch.Tensor:
        x = x + self.drop_path1(self.gamma_1.to(x.dtype) * self.attn.proj(a), m1)
        return x + self.drop_path2(self.gamma_2.to(x.dtype) * self.mlp(self.norm2(x)), m2)

    def forward(self, x: torch.Tensor, masks: tuple = (None, None),
                remat_block: bool = False) -> torch.Tensor:
        if not remat_block:
            return self._attn_out(x, standard_attention(self._attn_in(x), self.attn.num_heads),
                                  *masks)
        a = standard_attention(remat(self._attn_in, x), self.attn.num_heads)
        return remat(self._attn_out, x, a, *masks)


class PatchEmbed(nn.Module):
    """Patch embed of RGB images as patchify + one matmul (stride == kernel)."""

    def __init__(self, patch_size: int, embed_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(patch_size * patch_size * 3, embed_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        out = self.proj(_patchify(x, p))
        return out.reshape(b, (h // p) * (w // p), -1)
