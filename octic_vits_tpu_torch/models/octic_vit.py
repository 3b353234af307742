"""Hybrid and invariant-early octic Vision Transformers (counterpart of
octic_vits_tpu/models/octic_vit.py in the configurations the benchmark, the
DeiT III trainer and the DINOv2 trainer run: flat-E or packed carry; in the octic
blocks the fused qkv + attention and fused MLP kernels in eval mode, and
``octic_attention`` (or, with ``fuse_qkv``, the fused qkv + attention) and
two ``linear_d8_fused`` kernels in train mode; the attention and fc1 + GELU
kernels in the standard blocks). The DINOv2 interface (mask tokens, the
token dict) is models/dinov2_vit.py.

The first ``break_layer`` blocks (``octic_equi_break_layer``, depth // 2
unless set) are D8-equivariant and carry the flat-E 5-tuple, or with
``packed_carry`` ONE packed ``[B, N, C]`` container (d8/group.py); at the
break the octic stream is concatenated to ``[B, N, C]`` in isotypic slot
order (hybrid) or, with ``invariant``, invariantized and projected back to
C (invariant-early), and standard blocks finish the network. Images are
NHWC. The flax ``lax.scan`` trunk becomes a plain ``nn.ModuleList``;
``remat`` is its per-block rematerialization. ``dtype`` is the parameter
dtype and ``compute_dtype`` the activations' (the flax ``param_dtype`` and
``dtype``); parameters are cast at use. In training mode with
``drop_path_rate > 0`` the forward takes a ``torch.Generator`` and draws
every block's drop-path masks from it before the trunk runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from octic_vits_tpu_torch.d8.group import (
    SQRT2_OVER_2,
    flat_to_break,
    pack_5_to_flat,
    pack_8_to_5f,
    unpack_5f_to_8,
    unpack_flat_to_5,
)
from octic_vits_tpu_torch.d8.posembed import resize_posembed, unfold_quadrant
from octic_vits_tpu_torch.layers.common import Dropout, draw_block_masks
from octic_vits_tpu_torch.layers.d8_layers import BlockD8, PatchEmbedD8, normal_, trunc_normal_
from octic_vits_tpu_torch.layers.invariants import make_invariant
from octic_vits_tpu_torch.layers.vit_layers import Block, LayerNorm, Linear
from octic_vits_tpu_torch.utils import tracing


class OcticVisionTransformer(nn.Module):
    """``num_classes=0`` leaves out the head (``forward`` returns the
    features); ``cls_init`` is "deit" (truncated normal 0.16) or "dinov2"
    (normal 1e-6); ``fuse_qkv`` runs the octic blocks' qkv inside the fused
    qkv + attention op in training too (the DINOv2 flags).
    ``use_pallas_linear``, ``use_pallas_gelu``, ``fuse_mlp_branch`` and
    ``fuse_block_epilogues`` go to the octic blocks (:class:`BlockD8`), with
    the JAX defaults except ``use_pallas_linear``: the port's octic blocks
    always run the configurations of the bench and train flags, which set
    it, so it defaults on here. ``fuse_mlp`` runs the fused MLP op in
    training too (differentiable). ``invariant`` breaks the equivariance with
    ``invariant_kind`` (any of the seven kinds of ``layers.invariants``) and
    ``invariant_proj``, a ``Linear`` from its features to C. ``packed_carry`` packs
    the octic stream into one ``[B, N, C]`` container at trunk entry; the
    octic blocks take the packed ops where their fused ops run (eval mode,
    or ``fuse_qkv`` and ``fuse_mlp`` in training, as the JAX docstring asks)
    and unpack to the flat-E views elsewhere, as the JAX layers do.
    ``use_wide_qkv`` runs the octic blocks' attention as the wide-1d qkv
    product and :func:`~octic_vits_tpu_torch.ops.octic_attention_wide1d`
    (kernel row 12) in both modes, over the same parameters; off by default,
    as in JAX (models/octic_vit.py:78).

    ``octic_equi_break_layer`` places the break (``None``: depth // 2, which
    needs an even depth; else ``0 <= b < depth``). ``global_pool`` drops the
    cls token and pools the mean of every token. ``num_register_tokens``
    adds ``register_tokens_a1`` (only the A1 slot a parameter, as the cls
    token), inserted after token 0 as JAX's ``_cat_cls_and_registers`` does:
    with ``global_pool`` token 0 is the first patch token, a JAX quirk the
    port copies. ``drop_rate`` is the blocks' proj and MLP dropout and the
    head input's; ``attn_drop_rate`` the blocks' attention dropout (the
    eager attention in training; see :class:`AttentionD8`). Their masks come
    from the forward's generator, drawn before the trunk runs."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, proj_bias: bool = True,
                 ffn_bias: bool = True, init_scale: float = 1e-4,
                 drop_path_rate: float = 0.0, cls_init: str = "deit", fuse_qkv: bool = False,
                 remat: bool = False, compute_dtype: Optional[torch.dtype] = None,
                 num_register_tokens: int = 0, invariant: bool = False,
                 invariant_kind: str = "power_spectrum", packed_carry: bool = False,
                 use_pallas_linear: bool = True, use_pallas_gelu: bool = False,
                 fuse_mlp_branch: bool = False, fuse_block_epilogues: bool = False,
                 fuse_mlp: bool = False, use_wide_qkv: bool = False,
                 octic_equi_break_layer: Optional[int] = None, global_pool: bool = False,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        if embed_dim % 8:
            raise ValueError("embed_dim must be divisible by 8")
        grid = img_size // patch_size
        if grid % 2:
            raise ValueError("patch grid must be even for the quadrant pos-embed")
        if octic_equi_break_layer is None:
            if depth % 2:
                raise ValueError("depth must be even")
            octic_equi_break_layer = depth // 2
        elif not 0 <= octic_equi_break_layer < depth:
            raise ValueError(f"octic_equi_break_layer must lie in [0, {depth}), got "
                             f"{octic_equi_break_layer}")
        if cls_init not in ("deit", "dinov2"):
            raise ValueError(f"cls_init must be 'deit' or 'dinov2', got {cls_init!r}")
        kw = dict(device=device, dtype=dtype)
        c8 = embed_dim // 8
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.depth = depth
        self.break_layer = octic_equi_break_layer
        self.num_register_tokens = num_register_tokens
        self.global_pool = global_pool
        self.cls_init = cls_init
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.packed_carry = packed_carry
        self.patch_embed = PatchEmbedD8(patch_size, embed_dim, **kw)
        # 6 quadrant tensors stacked: [6, grid/2, grid/2, C/8]
        self.pos_embed = nn.Parameter(torch.empty(6, grid // 2, grid // 2, c8, **kw))
        # only the A1 slot of the cls and register tokens is a parameter; the
        # others are 0
        self.cls_token_a1 = None if global_pool else nn.Parameter(torch.empty(1, 1, c8, **kw))
        self.register_tokens_a1 = (nn.Parameter(torch.empty(1, num_register_tokens, c8, **kw))
                                   if num_register_tokens else None)
        self.invariantization = self.invariant_proj = None
        if invariant:
            self.invariantization = make_invariant(invariant_kind, embed_dim, **kw)
            self.invariant_proj = Linear(self.invariantization.output_dim, embed_dim, **kw)
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, layerscale_init=init_scale,
                      drop_path=drop_path_rate, proj_bias=proj_bias, ffn_bias=ffn_bias,
                      drop=drop_rate, attn_drop=attn_drop_rate, **kw)
        octic = dict(fuse_qkv=fuse_qkv, use_pallas_linear=use_pallas_linear,
                     use_pallas_gelu=use_pallas_gelu, fuse_mlp_branch=fuse_mlp_branch,
                     fuse_block_epilogues=fuse_block_epilogues, fuse_mlp=fuse_mlp,
                     use_wide_qkv=use_wide_qkv)
        self.blocks = nn.ModuleList(
            BlockD8(embed_dim, num_heads, **octic, **common) if i < self.break_layer
            else Block(embed_dim, num_heads, norm_eps=1e-6, **common)
            for i in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=1e-6, **kw)
        self.head_drop = Dropout(drop_rate)
        self.head = Linear(embed_dim, num_classes, **kw) if num_classes > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 8 * 0.02
        trunc_normal_(self.pos_embed, SQRT2_OVER_2 * std, generator)
        if self.cls_token_a1 is not None and self.cls_init == "deit":
            trunc_normal_(self.cls_token_a1, std, generator)
        elif self.cls_token_a1 is not None:
            normal_(self.cls_token_a1, 1e-6, generator)
        if self.register_tokens_a1 is not None:
            normal_(self.register_tokens_a1, 1e-6, generator)

    def _pos_embed_8tuple(self, grid_hw: tuple) -> tuple:
        pos8 = unfold_quadrant(tuple(self.pos_embed[i] for i in range(6)), dim=0)
        return resize_posembed(pos8, grid_hw)

    def _add_pos(self, xs: tuple, grid_hw: tuple) -> tuple:
        pos5 = pack_8_to_5f(self._pos_embed_8tuple(grid_hw))
        dt = xs[0].dtype
        return tuple(x + p.reshape(-1, p.shape[-1]).to(dt) for x, p in zip(xs, pos5))

    @staticmethod
    def _tokens5(a1: torch.Tensor, batch: int) -> tuple:
        """Flat-E tokens whose A1 slot is the parameter `a1` ``[1, r, C/8]``
        and whose other slots are 0."""
        a1 = a1.expand(batch, -1, -1)
        zeros = torch.zeros_like(a1)
        return (a1, zeros, zeros, zeros, torch.cat((zeros,) * 4, dim=-1))

    def _cat_cls_and_registers(self, xs: tuple, batch: int) -> tuple:
        """The cls token first (none with ``global_pool``), then the register
        tokens after token 0 (octic_vit.py:_cat_cls_and_registers: with
        ``global_pool`` token 0 is the first patch token)."""
        dt = xs[0].dtype
        if self.cls_token_a1 is not None:
            cls5 = self._tokens5(self.cls_token_a1.to(dt), batch)
            xs = tuple(torch.cat((c, x), dim=1) for c, x in zip(cls5, xs))
        if self.register_tokens_a1 is not None:
            reg5 = self._tokens5(self.register_tokens_a1.to(dt), batch)
            xs = tuple(torch.cat((x[:, :1], g, x[:, 1:]), dim=1) for g, x in zip(reg5, xs))
        return xs

    def _break_to_flat(self, xs) -> torch.Tensor:
        """Equivariance break of the flat-E tuple or the packed container
        (octic_vit.py:250-271): the invariant features projected to C
        (invariant-early), else [A1|A2|B1|B2|E11|E21|E12|E22] along
        channels (hybrid)."""
        if isinstance(xs, torch.Tensor):
            if self.invariantization is None:
                return flat_to_break(xs)
            xs = unpack_flat_to_5(xs)
        elif self.invariantization is None:
            return torch.cat(unpack_5f_to_8(xs), dim=-1)
        else:
            xs = tuple(xs[:4]) + (xs[4].unflatten(-1, (2, -1)),)  # E [..., 2, C/4]
        return self.invariant_proj(self.invariantization(xs))

    def _run_to_break(self, xs: tuple, masks: list) -> torch.Tensor:
        """The octic blocks on the token tuple (packed first with
        ``packed_carry``) and the break: the ``[B, N, C]`` input of the first
        standard block. `masks` holds every block's drop-path masks."""
        with tracing.span("vit.octic_blocks"):
            if self.packed_carry:
                xs = pack_5_to_flat(xs)
            rb = self.remat and self.training
            for blk, m in zip(self.blocks[: self.break_layer], masks):
                xs = blk(xs, m, rb)
        with tracing.span("vit.break"):
            return self._break_to_flat(xs)

    def _trunk(self, xs: tuple, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The blocks on the token tuple: octic blocks, the break, standard
        blocks. Every block's drop-path and dropout masks are drawn from
        `generator` before the first block runs. Returns the pre-norm ``[B,
        N, C]``."""
        x0 = xs[0]
        with tracing.span("vit.masks"):
            masks = draw_block_masks(self.blocks, x0.shape[0], generator, device=x0.device,
                                     dtype=x0.dtype, tokens=x0.shape[1])
        z = self._run_to_break(xs, masks)
        with tracing.span("vit.standard_blocks"):
            rb = self.remat and self.training
            for blk, m in zip(self.blocks[self.break_layer:], masks[self.break_layer:]):
                z = blk(z, m, rb)
        return z

    def _pre_norm(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """NHWC images -> the trunk's pre-norm ``[B, N, C]``."""
        b, h, w, _ = x.shape
        with tracing.span("vit.embed"):
            x = x.to(self.compute_dtype or self.pos_embed.dtype)
            grid_hw = (h // self.patch_size, w // self.patch_size)
            xs = self._cat_cls_and_registers(self._add_pos(self.patch_embed(x), grid_hw), b)
        return self._trunk(xs, generator)

    def _pooled(self, z: torch.Tensor) -> torch.Tensor:
        z = self.norm(z)
        return z.mean(dim=1) if self.global_pool else z[:, 0]

    def forward_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with tracing.span("vit.forward"):
            z = self._pre_norm(x, generator)
            with tracing.span("vit.head"):
                return self._pooled(z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with tracing.span("vit.forward"):
            z = self._pre_norm(x, generator)
            with tracing.span("vit.head"):
                z = self._pooled(z)
                # the head input's dropout mask is drawn after the trunk's masks
                z = self.head_drop(z, self.head_drop.draw(tuple(z.shape), generator,
                                                          device=z.device))
                return z if self.head is None else self.head(z)

