"""Standard ViT layers for the standard half of the hybrid model and for the
standard comparators. Counterpart of the ``use_pallas_*`` paths of
octic_vits_tpu/layers/vit_layers.py: attention through
:func:`standard_attention`, the MLP's fc1 through :func:`dense_gelu` (both
differentiable); qkv, proj, fc2, the SwiGLU FFN, the hMLP stem and the patch
embed are plain linear products. In training with attention dropout the
attention is JAX's einsum path (:func:`attention_eager`). Parameters are cast to the activations' dtype at use (f32
parameters under bf16 compute in training). Inputs are NHWC images /
``[B, N, C]`` tokens."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.layers.common import Dropout, DropPathMask, cast, dropout, remat
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
    """fc1 + GELU (:func:`dense_gelu`) -> dropout -> fc2 -> dropout; the masks
    of ``forward(x, masks)`` come from :meth:`draw_masks`."""

    def __init__(self, in_features: int, hidden_features: int, bias: bool = True,
                 drop: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(in_features, hidden_features, bias=bias, **kw)
        self.fc2 = Linear(hidden_features, in_features, bias=bias, **kw)
        self.drop = Dropout(drop)

    def draw_masks(self, batch: int, tokens: int, generator, device=None) -> tuple:
        """The hidden's and the output's dropout masks (``None`` when off)."""
        shapes = ((batch, tokens, self.fc1.out_features), (batch, tokens, self.fc2.out_features))
        return tuple(self.drop.draw(s, generator, device=device) for s in shapes)

    def forward(self, x: torch.Tensor, masks: tuple = (None, None)) -> torch.Tensor:
        dt = x.dtype
        h = self.drop(dense_gelu(x, self.fc1.weight.to(dt), cast(self.fc1.bias, dt)), masks[0])
        return self.drop(self.fc2(h), masks[1])


def swiglu_hidden(hidden_features: int) -> int:
    """The SwiGLU hidden width: 2/3 of `hidden_features`, rounded up to a
    multiple of 8 (vit_layers.py:SwiGLUFFN)."""
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8


class SwiGLUFFN(nn.Module):
    """The DINOv2 SwiGLU FFN: ``w3(silu(x1) * x2)`` with ``[x1 | x2] =
    w12(x)``. Plain products and elementwise ops, as JAX computes it outside
    any Pallas kernel; it has no dropout."""

    def __init__(self, in_features: int, hidden_features: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        hidden = swiglu_hidden(hidden_features)
        self.w12 = Linear(in_features, 2 * hidden, bias=bias, **kw)
        self.w3 = Linear(hidden, in_features, bias=bias, **kw)

    def draw_masks(self, batch: int, tokens: int, generator, device=None) -> tuple:
        return (None, None)

    def forward(self, x: torch.Tensor, masks: tuple = (None, None)) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def attention_eager(qkv: torch.Tensor, num_heads: int, u: Optional[torch.Tensor] = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Softmax attention of a ``[B, N, 3C]`` qkv as the JAX layer's einsum
    path computes it (vit_layers.py:Attention): f32 logits and softmax,
    dropout at `rate` on the probabilities with the uniforms `u` ``[B, H, N,
    N]`` (:func:`~octic_vits_tpu_torch.layers.common.dropout`), the
    probabilities cast back to the qkv's dtype for the product with v."""
    b, n, w = qkv.shape
    c = w // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (c // num_heads) ** -0.5
    probs = dropout(logits.softmax(-1), u, rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(b, n, c)


class Attention(nn.Module):
    """qkv -> attention -> proj -> dropout. The attention is the kernel
    (:func:`standard_attention`) except in training with ``attn_drop > 0``,
    where it is :func:`attention_eager` with dropout on the probabilities: the
    path JAX selects by the same rule (vit_layers.py:Attention), chosen by
    configuration, never on a kernel's failure."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False, proj_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, bias=proj_bias, **kw)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def draw_masks(self, batch: int, tokens: int, generator, device=None) -> tuple:
        """The probabilities' and the output's dropout masks (``None`` when off)."""
        c = self.proj.out_features
        return (self.attn_drop.draw((batch, self.num_heads, tokens, tokens), generator,
                                    device=device),
                self.proj_drop.draw((batch, tokens, c), generator, device=device))

    def attention(self, qkv: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attn_drop.active():
            if u is None:
                raise ValueError("attention dropout in training needs the masks of draw_masks")
            return attention_eager(qkv, self.num_heads, u, self.attn_drop.rate)
        return standard_attention(qkv, self.num_heads)

    def project(self, a: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.proj_drop(self.proj(a), u)

    def forward(self, x: torch.Tensor, masks: tuple = (None, None)) -> torch.Tensor:
        return self.project(self.attention(self.qkv(x), masks[0]), masks[1])


def _scale(gamma: Optional[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    return y if gamma is None else gamma.to(y.dtype) * y


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (``gamma_1``, ``gamma_2``;
    none with ``layerscale_init=None``), drop path and dropout, the DeiT III
    and DINOv2 block; ``ffn_layer`` "mlp" or "swiglu" (:class:`SwiGLUFFN`).
    ``forward(x, masks, remat_block)`` as d8_layers.BlockD8: `masks` from
    :meth:`draw_masks`; with `remat_block` the norm1 + qkv and the proj ...
    MLP halves are rematerialized around the attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, layerscale_init: Optional[float] = 1e-4,
                 norm_eps: float = 1e-6, drop_path: float = 0.0, proj_bias: bool = True,
                 ffn_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 ffn_layer: str = "mlp", *, device=None, dtype=None):
        super().__init__()
        if ffn_layer not in ("mlp", "swiglu"):
            raise ValueError(f"ffn_layer must be 'mlp' or 'swiglu', got {ffn_layer!r}")
        kw = dict(device=device, dtype=dtype)
        self.layerscale_init = layerscale_init
        self.norm1 = LayerNorm(dim, eps=norm_eps, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, attn_drop, drop, **kw)
        ls = layerscale_init is not None
        self.gamma_1 = nn.Parameter(torch.empty(dim, **kw)) if ls else None
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps, **kw)
        hidden = int(dim * mlp_ratio)
        self.mlp = (SwiGLUFFN(dim, hidden, ffn_bias, **kw) if ffn_layer == "swiglu"
                    else Mlp(dim, hidden, ffn_bias, drop, **kw))
        self.gamma_2 = nn.Parameter(torch.empty(dim, **kw)) if ls else None
        self.drop_path2 = DropPath(drop_path)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.gamma_1 is not None:
            nn.init.constant_(self.gamma_1, self.layerscale_init)
            nn.init.constant_(self.gamma_2, self.layerscale_init)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator], *, device=None,
                   dtype=None, tokens: int = 0) -> tuple:
        """The two drop-path masks, and where dropout is on in training a third
        entry: the masks of the probabilities, the proj and the MLP's hidden
        and output at `tokens` tokens."""
        kw = dict(device=device, dtype=dtype)
        masks = (self.drop_path1.draw(batch, generator, **kw),
                 self.drop_path2.draw(batch, generator, **kw))
        drop = (self.attn.draw_masks(batch, tokens, generator, device)
                + self.mlp.draw_masks(batch, tokens, generator, device))
        return masks if all(u is None for u in drop) else masks + (drop,)

    def _attn_in(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn.qkv(self.norm1(x))

    def _attn_out(self, x, a, m1, m2, drop=None) -> torch.Tensor:
        d = drop or (None,) * 4
        x = x + self.drop_path1(_scale(self.gamma_1, self.attn.project(a, d[1])), m1)
        return x + self.drop_path2(_scale(self.gamma_2, self.mlp(self.norm2(x), d[2:])), m2)

    def forward(self, x: torch.Tensor, masks: tuple = (None, None),
                remat_block: bool = False) -> torch.Tensor:
        m1, m2 = masks[:2]
        drop = masks[2] if len(masks) > 2 else None
        u = None if drop is None else drop[0]
        if not remat_block:
            return self._attn_out(x, self.attn.attention(self._attn_in(x), u), m1, m2, drop)
        a = self.attn.attention(remat(self._attn_in, x), u)
        return remat(self._attn_out, x, a, m1, m2, drop)


class HMLPStem(nn.Module):
    """The hMLP stem (vit_layers.py:HMLPStem): three patchify + Linear +
    LayerNorm stages at strides 4, 2, 2 (GELU after the first two), NHWC
    images -> ``[B, N, embed_dim]`` tokens at patch 16."""

    STRIDES = (4, 2, 2)

    def __init__(self, embed_dim: int = 768, in_chans: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_dim = embed_dim
        dims = (embed_dim // 4, embed_dim // 4, embed_dim)
        c = in_chans
        for i, (d, s) in enumerate(zip(dims, self.STRIDES)):
            setattr(self, f"proj{i}", Linear(s * s * c, d, **kw))
            setattr(self, f"norm{i}", LayerNorm(d, eps=1e-6, **kw))
            c = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        for i, s in enumerate(self.STRIDES):
            _, h, w, _ = x.shape
            x = getattr(self, f"norm{i}")(getattr(self, f"proj{i}")(_patchify(x, s)))
            if i < 2:
                x = F.gelu(x)
            x = x.reshape(b, h // s, w // s, -1)
        return x.reshape(b, -1, self.embed_dim)


class ParallelBlockx2(nn.Module):
    """The DeiT III parallel block (vit_layers.py:ParallelBlockx2): two
    attention branches ``a``, ``b`` added to the residual, then two MLP
    branches on the result, each with its LayerScale and drop path.
    ``forward(x, masks)`` with `masks` from :meth:`draw_masks`."""

    TAGS = ("a", "b")

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, layerscale_init: float = 1e-4, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layerscale_init = layerscale_init
        for t in self.TAGS:
            setattr(self, f"norm1_{t}", LayerNorm(dim, eps=1e-6, **kw))
            setattr(self, f"attn_{t}", Attention(dim, num_heads, qkv_bias, True, attn_drop, drop,
                                                 **kw))
            setattr(self, f"gamma_1_{t}", nn.Parameter(torch.empty(dim, **kw)))
            setattr(self, f"norm2_{t}", LayerNorm(dim, eps=1e-6, **kw))
            setattr(self, f"mlp_{t}", Mlp(dim, int(dim * mlp_ratio), True, drop, **kw))
            setattr(self, f"gamma_2_{t}", nn.Parameter(torch.empty(dim, **kw)))
        self.drop_path = DropPath(drop_path)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for t in self.TAGS:
            for g in (1, 2):
                nn.init.constant_(getattr(self, f"gamma_{g}_{t}"), self.layerscale_init)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator], *, device=None,
                   dtype=None, tokens: int = 0) -> tuple:
        """The four branches' drop-path masks (attention a, b, MLP a, b), then
        their dropout masks."""
        kw = dict(device=device, dtype=dtype)
        paths = tuple(self.drop_path.draw(batch, generator, **kw) for _ in range(4))
        drops = tuple(getattr(self, f"{m}_{t}").draw_masks(batch, tokens, generator, device)
                      for m in ("attn", "mlp") for t in self.TAGS)
        return paths + drops

    def forward(self, x: torch.Tensor, masks: Optional[tuple] = None) -> torch.Tensor:
        masks = masks or (None,) * 4 + ((None, None),) * 4

        def branch(kind, t, z, i):
            k = 1 if kind == "attn" else 2  # norm1 / gamma_1 or norm2 / gamma_2
            y = getattr(self, f"{kind}_{t}")(getattr(self, f"norm{k}_{t}")(z), masks[4 + i])
            return self.drop_path(getattr(self, f"gamma_{k}_{t}").to(y.dtype) * y, masks[i])

        x = x + branch("attn", "a", x, 0) + branch("attn", "b", x, 1)
        return x + branch("mlp", "a", x, 2) + branch("mlp", "b", x, 3)


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
