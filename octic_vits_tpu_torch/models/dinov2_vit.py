"""DINOv2-interface backbones (counterpart of
octic_vits_tpu/models/dinov2_vit.py): the hybrid
:class:`OcticDinoVisionTransformer` and the standard comparator
:class:`DinoVisionTransformer`.

Both give the SSL trainer ``prepare_tokens_with_masks`` (iBOT mask-token
substitution), ``forward_features`` returning the token dict and the
multi-crop ``forward_features_list``. The positional embedding is resized
to each crop's patch grid (6 x 6 for a 96^2 local crop at patch 16). In
training with drop path, ``forward_features`` takes a ``torch.Generator``
and draws the masks of every block from it before the trunk runs.
``get_intermediate_layers`` (the eval probes), registers, the
invariant-early backbones and the packed carry on the SSL trunk are not
ported yet: the octic backbone raises for ``invariant`` and
``packed_carry``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from octic_vits_tpu_torch.d8.group import pack_8_to_5f, unpack_5f_to_8
from octic_vits_tpu_torch.d8.posembed import resize_grid
from octic_vits_tpu_torch.layers.common import draw_block_masks
from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_
from octic_vits_tpu_torch.layers.vit_layers import Block, LayerNorm, PatchEmbed
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer


def _output_dict(z_norm: torch.Tensor, z: torch.Tensor, masks) -> dict:
    return {
        "x_norm_clstoken": z_norm[:, 0],
        "x_norm_regtokens": z_norm[:, 1:1],
        "x_norm_patchtokens": z_norm[:, 1:],
        "x_prenorm": z,
        "masks": masks,
    }


class OcticDinoVisionTransformer(OcticVisionTransformer):
    """The hybrid backbone with the DINOv2 SSL interface: biases on, no head,
    the DINOv2 cls init, and a per-irrep mask token of which only the A1 slot
    is a parameter (``mask_token_a1``; the other seven slots are zeros). The
    mask token replaces the patch embedding before the pos-embed is added,
    in the 8-tuple form."""

    def __init__(self, qkv_bias: bool = True, num_classes: int = 0, cls_init: str = "dinov2",
                 **kwargs):
        if kwargs.get("invariant") or kwargs.get("packed_carry"):
            raise NotImplementedError("the invariant-early DINOv2 backbones and the packed carry "
                                      "on the SSL trunk are not ported yet")
        super().__init__(qkv_bias=qkv_bias, num_classes=num_classes, cls_init=cls_init, **kwargs)
        p = self.cls_token_a1
        self.mask_token_a1 = nn.Parameter(torch.empty(1, self.embed_dim // 8, device=p.device,
                                                      dtype=p.dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        nn.init.zeros_(self.mask_token_a1)

    def prepare_tokens_with_masks(self, x: torch.Tensor,
                                  masks: Optional[torch.Tensor] = None) -> tuple:
        """NHWC crops (in the compute dtype) and optional ``[B, N]`` bool
        masks -> the flat-E token tuple with the cls token first."""
        b, h, w, _ = x.shape
        grid_hw = (h // self.patch_size, w // self.patch_size)
        xs8 = unpack_5f_to_8(self.patch_embed(x))
        dt = xs8[0].dtype
        if masks is not None:
            m = masks[..., None]
            xs8 = (torch.where(m, self.mask_token_a1.to(dt), xs8[0]),) + tuple(
                t.masked_fill(m, 0.0) for t in xs8[1:])
        pos8 = self._pos_embed_8tuple(grid_hw)
        xs8 = tuple(t + p.reshape(-1, p.shape[-1]).to(dt) for t, p in zip(xs8, pos8))
        return self._cat_cls(pack_8_to_5f(xs8), b)

    def forward_features(self, x, masks=None, generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            return self.forward_features_list(x, masks, generator)
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        z = self._trunk(self.prepare_tokens_with_masks(x, masks), generator)
        return _output_dict(self.norm(z), z, masks)

    def forward_features_list(self, x_list, masks_list,
                              generator: Optional[torch.Generator] = None) -> list:
        return [self.forward_features(x, m, generator) for x, m in zip(x_list, masks_list)]

    def forward(self, x, masks=None, generator: Optional[torch.Generator] = None,
                is_training: bool = False):
        ret = self.forward_features(x, masks, generator)
        return ret if is_training else ret["x_norm_clstoken"]


class DinoVisionTransformer(nn.Module):
    """The standard DINOv2 ViT (the comparator of the hybrid), on the same
    standard blocks and kernels as the hybrid's second half. Its pos-embed
    ``[1, grid^2 + 1, C]`` includes the cls slot; the patch part is resized
    to each crop's grid."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True, ffn_bias: bool = True,
                 drop_path_rate: float = 0.0, layerscale_init: float = 1.0,
                 num_register_tokens: int = 0, ffn_layer: str = "mlp", remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, *, device=None, dtype=None):
        super().__init__()
        if num_register_tokens or ffn_layer != "mlp":
            raise NotImplementedError("registers and the SwiGLU FFN are not ported yet")
        kw = dict(device=device, dtype=dtype)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.grid = img_size // patch_size
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid ** 2 + 1, embed_dim, **kw))
        self.mask_token = nn.Parameter(torch.empty(1, embed_dim, **kw))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  layerscale_init=layerscale_init, norm_eps=1e-6, drop_path=drop_path_rate,
                  proj_bias=proj_bias, ffn_bias=ffn_bias, **kw)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        trunc_normal_(self.pos_embed, 0.02, generator)
        nn.init.zeros_(self.mask_token)

    def prepare_tokens_with_masks(self, x: torch.Tensor,
                                  masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = self.patch_embed(x)
        dt = x.dtype
        if masks is not None:
            x = torch.where(masks[..., None], self.mask_token.to(dt), x)
        x = torch.cat((self.cls_token.to(dt).expand(b, 1, -1), x), dim=1)
        patch_pos = self.pos_embed[0, 1:].reshape(self.grid, self.grid, self.embed_dim)
        patch_pos = resize_grid(patch_pos, (h // self.patch_size, w // self.patch_size))
        pos = torch.cat((self.pos_embed[0, :1], patch_pos.reshape(-1, self.embed_dim)), dim=0)
        return x + pos.to(dt)

    def forward_features(self, x, masks=None, generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            return self.forward_features_list(x, masks, generator)
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        z = self.prepare_tokens_with_masks(x, masks)
        block_masks = draw_block_masks(self.blocks, z.shape[0], generator, device=z.device,
                                       dtype=z.dtype)
        rb = self.remat and self.training
        for blk, m in zip(self.blocks, block_masks):
            z = blk(z, m, rb)
        return _output_dict(self.norm(z), z, masks)

    def forward_features_list(self, x_list, masks_list,
                              generator: Optional[torch.Generator] = None) -> list:
        return [self.forward_features(x, m, generator) for x, m in zip(x_list, masks_list)]

    def forward(self, x, masks=None, generator: Optional[torch.Generator] = None,
                is_training: bool = False):
        ret = self.forward_features(x, masks, generator)
        return ret if is_training else ret["x_norm_clstoken"]
