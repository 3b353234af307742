"""Standard DeiT III LayerScale ViT (counterpart of
octic_vits_tpu/models/vit.py): the comparator of the hybrid model, built
from the same standard layers and kernels, with the same training options
(``drop_path_rate``, ``remat``, ``compute_dtype``; see models/octic_vit.py).
NHWC images; per-patch pos-embed added before the cls token is prepended."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from octic_vits_tpu_torch.layers.common import draw_block_masks
from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_
from octic_vits_tpu_torch.layers.vit_layers import Block, LayerNorm, Linear, PatchEmbed


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 init_scale: float = 1e-4, norm_eps: float = 1e-5, drop_path_rate: float = 0.0,
                 remat: bool = False, compute_dtype: Optional[torch.dtype] = None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.remat = remat
        self.compute_dtype = compute_dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid, embed_dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, **kw))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  layerscale_init=init_scale, norm_eps=norm_eps, drop_path=drop_path_rate, **kw)
            for _ in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=norm_eps, **kw)
        self.head = Linear(embed_dim, num_classes, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_embed, 0.02, generator)
        trunc_normal_(self.cls_token, 0.02, generator)

    def forward_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        masks = draw_block_masks(self.blocks, x.shape[0], generator, device=x.device,
                                 dtype=x.dtype)
        rb = self.remat and self.training
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat((cls, x), dim=1)
        for blk, m in zip(self.blocks, masks):
            x = blk(x, m, rb)
        return self.norm(x)[:, 0]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.forward_features(x, generator))
