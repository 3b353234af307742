"""Hybrid octic Vision Transformer, inference (counterpart of
octic_vits_tpu/models/octic_vit.py in the configuration the benchmark runs:
flat-E carry, fused qkv + attention and fused MLP kernels in the octic
blocks, the attention and fc1 + GELU kernels in the standard blocks).

The first ``break_layer`` blocks are D8-equivariant and carry the flat-E
5-tuple; at the break the tuple is concatenated to ``[B, N, C]`` in
isotypic slot order and standard blocks finish the network. Images are
NHWC. The flax ``lax.scan`` trunk becomes a plain ``nn.ModuleList``.
"""

from __future__ import annotations

import torch
from torch import nn

from octic_vits_tpu_torch.d8.group import SQRT2_OVER_2, pack_8_to_5f, unpack_5f_to_8
from octic_vits_tpu_torch.d8.posembed import resize_posembed, unfold_quadrant
from octic_vits_tpu_torch.layers.d8_layers import BlockD8, PatchEmbedD8, trunc_normal_
from octic_vits_tpu_torch.layers.vit_layers import Block


class OcticVisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, init_scale: float = 1e-4, *,
                 device=None, dtype=None):
        super().__init__()
        if embed_dim % 8:
            raise ValueError("embed_dim must be divisible by 8")
        grid = img_size // patch_size
        if grid % 2:
            raise ValueError("patch grid must be even for the quadrant pos-embed")
        if depth % 2:
            raise ValueError("depth must be even")
        kw = dict(device=device, dtype=dtype)
        c8 = embed_dim // 8
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.break_layer = depth // 2  # the first half of the blocks is octic
        self.patch_embed = PatchEmbedD8(patch_size, embed_dim, **kw)
        # 6 quadrant tensors stacked: [6, grid/2, grid/2, C/8]
        self.pos_embed = nn.Parameter(torch.empty(6, grid // 2, grid // 2, c8, **kw))
        # only the A1 slot of the cls token is a parameter; the others are 0
        self.cls_token_a1 = nn.Parameter(torch.empty(1, 1, c8, **kw))
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, layerscale_init=init_scale, **kw)
        self.blocks = nn.ModuleList(
            BlockD8(embed_dim, num_heads, **common) if i < self.break_layer
            else Block(embed_dim, num_heads, norm_eps=1e-6, **common)
            for i in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 8 * 0.02
        trunc_normal_(self.pos_embed, SQRT2_OVER_2 * std, generator)
        trunc_normal_(self.cls_token_a1, std, generator)

    def _add_pos(self, xs: tuple, grid_hw: tuple) -> tuple:
        pos8 = unfold_quadrant(tuple(self.pos_embed[i] for i in range(6)), dim=0)
        pos5 = pack_8_to_5f(resize_posembed(pos8, grid_hw))
        dt = xs[0].dtype
        return tuple(x + p.reshape(-1, p.shape[-1]).to(dt) for x, p in zip(xs, pos5))

    def _cat_cls(self, xs: tuple, batch: int) -> tuple:
        c8 = self.embed_dim // 8
        dt = xs[0].dtype
        cls_a1 = self.cls_token_a1.to(dt).expand(batch, 1, c8)
        zeros = torch.zeros_like(cls_a1)
        zeros_e = torch.zeros(batch, 1, 4 * c8, device=cls_a1.device, dtype=dt)
        cls5 = (cls_a1, zeros, zeros, zeros, zeros_e)
        return tuple(torch.cat((c, x), dim=1) for c, x in zip(cls5, xs))

    @staticmethod
    def _break_to_flat(xs: tuple) -> torch.Tensor:
        """Equivariance break: [A1|A2|B1|B2|E11|E21|E12|E22] along channels."""
        return torch.cat(unpack_5f_to_8(xs), dim=-1)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        grid_hw = (h // self.patch_size, w // self.patch_size)
        xs = self.patch_embed(x)
        xs = self._cat_cls(self._add_pos(xs, grid_hw), b)
        for blk in self.blocks[: self.break_layer]:
            xs = blk(xs)
        z = self._break_to_flat(xs)
        for blk in self.blocks[self.break_layer:]:
            z = blk(z)
        return self.norm(z)[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(x))
