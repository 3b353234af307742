"""DINOv2-interface backbones (counterpart of
octic_vits_tpu/models/dinov2_vit.py): the hybrid
:class:`OcticDinoVisionTransformer` and the standard comparator
:class:`DinoVisionTransformer`.

Both give the SSL trainer ``prepare_tokens_with_masks`` (iBOT mask-token
substitution), ``forward_features`` returning the token dict and the
multi-crop ``forward_features_list``, and ``get_intermediate_layers`` for
the eval probes. The positional embedding is resized to each crop's patch
grid (6 x 6 for a 96^2 local crop at patch 16). In training with drop path,
``forward_features`` takes a ``torch.Generator`` and draws the masks of
every block from it before the trunk runs. Both take register tokens
(``num_register_tokens``: the token dict's ``x_norm_regtokens``, and
``get_intermediate_layers`` skips them with the cls token); the octic
backbone takes the invariant-early break (``invariant``, any
``invariant_kind``) and the packed carry through the trunk it inherits,
the standard one the SwiGLU FFN (``ffn_layer="swiglu"``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from octic_vits_tpu_torch.d8.group import pack_8_to_5f, unpack_5f_to_8
from octic_vits_tpu_torch.d8.posembed import resize_grid
from octic_vits_tpu_torch.layers.common import draw_block_masks
from octic_vits_tpu_torch.layers.d8_layers import normal_, trunc_normal_
from octic_vits_tpu_torch.layers.vit_layers import Block, LayerNorm, PatchEmbed
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.utils import tracing


def _output_dict(z_norm: torch.Tensor, z: torch.Tensor, masks, r: int = 0) -> dict:
    """The token dict, with `r` register tokens after the cls token."""
    return {
        "x_norm_clstoken": z_norm[:, 0],
        "x_norm_regtokens": z_norm[:, 1:1 + r],
        "x_norm_patchtokens": z_norm[:, 1 + r:],
        "x_prenorm": z,
        "masks": masks,
    }


def _layers_to_take(n: Union[int, Sequence[int]], depth: int) -> list:
    """The last `n` blocks, or the blocks listed in `n`."""
    return list(range(depth - n, depth)) if isinstance(n, int) else list(n)


def _intermediate_outputs(model, x: torch.Tensor, outputs: list, reshape: bool,
                          return_class_token: bool, norm: bool) -> tuple:
    """The tail of ``get_intermediate_layers``: the final LayerNorm on each
    taken block's tokens, the cls token split off, the patch tokens as a
    ``[B, h, w, C]`` grid with `reshape`; the register tokens are dropped."""
    if norm:
        outputs = [model.norm(o) for o in outputs]
    cls_tokens = [o[:, 0] for o in outputs]
    outputs = [o[:, 1 + model.num_register_tokens:] for o in outputs]
    if reshape:
        b, h, w, _ = x.shape
        gh, gw = h // model.patch_size, w // model.patch_size
        outputs = [o.reshape(b, gh, gw, -1) for o in outputs]
    if return_class_token:
        return tuple(zip(outputs, cls_tokens))
    return tuple(outputs)


class OcticDinoVisionTransformer(OcticVisionTransformer):
    """The hybrid backbone with the DINOv2 SSL interface: biases on, no head,
    the DINOv2 cls init, and a per-irrep mask token of which only the A1 slot
    is a parameter (``mask_token_a1``; the other seven slots are zeros). The
    mask token replaces the patch embedding before the pos-embed is added,
    in the 8-tuple form; the register tokens follow the cls token."""

    def __init__(self, qkv_bias: bool = True, num_classes: int = 0, cls_init: str = "dinov2",
                 **kwargs):
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
        return self._cat_cls_and_registers(pack_8_to_5f(xs8), b)

    def forward_features(self, x, masks=None, generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            return self.forward_features_list(x, masks, generator)
        with tracing.span("vit.forward"):
            with tracing.span("vit.embed"):
                x = x.to(self.compute_dtype or self.pos_embed.dtype)
                xs = self.prepare_tokens_with_masks(x, masks)
            z = self._trunk(xs, generator)
            with tracing.span("vit.head"):
                return _output_dict(self.norm(z), z, masks, self.num_register_tokens)

    def forward_features_list(self, x_list, masks_list,
                              generator: Optional[torch.Generator] = None) -> list:
        return [self.forward_features(x, m, generator) for x, m in zip(x_list, masks_list)]

    def get_intermediate_layers(self, x: torch.Tensor, n: Union[int, Sequence[int]] = 1,
                                reshape: bool = False, return_class_token: bool = False,
                                norm: bool = True) -> tuple:
        """The tokens after each block in `n` (the last `n` blocks for an
        int), without drop path: patch tokens ``[B, N, C]`` (``[B, h, w,
        C]`` with `reshape`), each paired with its cls token under
        `return_class_token`, through the final LayerNorm under `norm`
        (JAX models/dinov2_vit.py:294). Every block taken must lie at or past
        the equivariance break."""
        take = _layers_to_take(n, self.depth)
        if not all(i >= self.break_layer for i in take):
            raise ValueError(f"intermediate layers must be past the equivariance break (got "
                             f"{take}, break at {self.break_layer})")
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        masks = [(None, None)] * self.depth
        z = self._run_to_break(self.prepare_tokens_with_masks(x), masks)
        outputs = []
        for i in range(self.break_layer, self.depth):
            z = self.blocks[i](z, masks[i], False)
            if i in take:
                outputs.append(z)
        return _intermediate_outputs(self, x, outputs, reshape, return_class_token, norm)

    def forward(self, x, masks=None, generator: Optional[torch.Generator] = None,
                is_training: bool = False):
        ret = self.forward_features(x, masks, generator)
        return ret if is_training else ret["x_norm_clstoken"]


class DinoVisionTransformer(nn.Module):
    """The standard DINOv2 ViT (the comparator of the hybrid, and the upstream
    DINOv2 backbones), on the same standard blocks and kernels as the
    hybrid's second half. Its pos-embed ``[1, grid^2 + 1, C]`` includes the
    cls slot; the patch part is resized to each crop's grid. The register
    tokens (``register_tokens``) go after the cls token once the pos-embed
    is added; ``ffn_layer="swiglu"`` takes :class:`SwiGLUFFN` (the giant's)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True, ffn_bias: bool = True,
                 drop_path_rate: float = 0.0, layerscale_init: Optional[float] = 1.0,
                 num_register_tokens: int = 0, ffn_layer: str = "mlp", remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_register_tokens = num_register_tokens
        self.grid = img_size // patch_size
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid ** 2 + 1, embed_dim, **kw))
        self.register_tokens = (nn.Parameter(torch.empty(1, num_register_tokens, embed_dim, **kw))
                                if num_register_tokens else None)
        self.mask_token = nn.Parameter(torch.empty(1, embed_dim, **kw))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  layerscale_init=layerscale_init, norm_eps=1e-6, drop_path=drop_path_rate,
                  proj_bias=proj_bias, ffn_bias=ffn_bias, ffn_layer=ffn_layer, **kw)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        trunc_normal_(self.pos_embed, 0.02, generator)
        if self.register_tokens is not None:
            normal_(self.register_tokens, 1e-6, generator)
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
        x = x + pos.to(dt)
        if self.register_tokens is None:
            return x
        regs = self.register_tokens.to(dt).expand(b, -1, -1)
        return torch.cat((x[:, :1], regs, x[:, 1:]), dim=1)

    def forward_features(self, x, masks=None, generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            return self.forward_features_list(x, masks, generator)
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        z = self.prepare_tokens_with_masks(x, masks)
        block_masks = draw_block_masks(self.blocks, z.shape[0], generator, device=z.device,
                                       dtype=z.dtype, tokens=z.shape[1])
        rb = self.remat and self.training
        for blk, m in zip(self.blocks, block_masks):
            z = blk(z, m, rb)
        return _output_dict(self.norm(z), z, masks, self.num_register_tokens)

    def forward_features_list(self, x_list, masks_list,
                              generator: Optional[torch.Generator] = None) -> list:
        return [self.forward_features(x, m, generator) for x, m in zip(x_list, masks_list)]

    def get_intermediate_layers(self, x: torch.Tensor, n: Union[int, Sequence[int]] = 1,
                                reshape: bool = False, return_class_token: bool = False,
                                norm: bool = True) -> tuple:
        """As :meth:`OcticDinoVisionTransformer.get_intermediate_layers`, any
        block (JAX models/dinov2_vit.py:166)."""
        take = _layers_to_take(n, self.depth)
        x = x.to(self.compute_dtype or self.pos_embed.dtype)
        z = self.prepare_tokens_with_masks(x)
        outputs = []
        for i, blk in enumerate(self.blocks):
            z = blk(z, (None, None), False)
            if i in take:
                outputs.append(z)
        return _intermediate_outputs(self, x, outputs, reshape, return_class_token, norm)

    def forward(self, x, masks=None, generator: Optional[torch.Generator] = None,
                is_training: bool = False):
        ret = self.forward_features(x, masks, generator)
        return ret if is_training else ret["x_norm_clstoken"]
