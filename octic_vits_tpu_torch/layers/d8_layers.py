"""D8-equivariant ViT layers as torch ``nn.Module``s on the flat-E 5-tuple
``(a1, a2, b1, b2, ef)`` (a* ``[B, N, C/8]``, ``ef [B, N, C/2] = [row0 | row1]``).

Counterpart of the paths of octic_vits_tpu/layers/d8_layers.py that the
benchmark flags (eval mode: fused qkv + attention, fused MLP), the DeiT
III train flags (train mode: ``octic_attention`` over a plain qkv LinearD8, fc1 and fc2
as two ``linear_d8_fused`` kernels, drop path, per-block remat) and the
DINOv2 train flags (the same, with the qkv inside the fused qkv + attention
op, ``fuse_qkv``) reach, with the flat-E carry; and of the fused-glue
options on top of them: the D8 LayerNorm kernel (``OCTIC_PALLAS_LN``),
``use_pallas_gelu`` with plain linears (``use_pallas_linear=False``),
``fuse_block_epilogues`` and ``fuse_mlp_branch``; and of the packed carry
(``packed_carry``: the block takes and returns ONE ``[B, N, C]`` container,
d8/group.py), whose norms, LayerScales, drop path and residual adds run as
full-width passes and whose attention and MLP take the packed-container
ops; and of ``use_wide_qkv`` (the wide-1d qkv and attention). The port
always runs the attention kernels (the JAX ``use_pallas_attention``), so
its LayerNorms always take the LN kernel when
``OCTIC_PALLAS_LN`` is on, as the JAX norms do under ``use_pallas_linear or
use_pallas_attention``. Parameter names and shapes follow the flax tree so
:func:`octic_vits_tpu_torch.utils.convert.params_from_jax` maps them one to
one; every module takes an explicit ``device`` and ``dtype`` (the parameter
dtype), is filled by ``reset_parameters(generator)``, and casts its
parameters to the dtype of its input activations at use, as the flax
modules cast ``param_dtype`` parameters to the compute ``dtype``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.d8.group import (
    SQRT2_OVER_4,
    pack_5_to_flat,
    pack_8_to_5f,
    unpack_packed_5f,
)
from octic_vits_tpu_torch.layers.common import DropPathMask, cast, remat
from octic_vits_tpu_torch.ops.attention import (
    octic_attention,
    octic_attention_fused_qkv,
    octic_attention_fused_qkv_packed,
    octic_attention_wide1d,
)
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_d8, gelu_d8_eager
from octic_vits_tpu_torch.ops.linear import (
    _lse_full,
    linear_d8,
    linear_d8_fused,
    linear_d8_wide1d,
    mlp_d8_fused,
    mlp_d8_packed,
)
from octic_vits_tpu_torch.ops.ln_d8 import ln_affine_d8_flat_tuple, ln_d8_flat_tuple
from octic_vits_tpu_torch.ops.mlp_branch import mlp_branch_d8

# The D8 LayerNorm kernel (ops/ln_d8.py) for the LayerNormD8s built with
# ``use_kernel``, as the JAX package's switch of the same name
# (d8_layers.py:311): off unless OCTIC_PALLAS_LN=1 is in the environment at
# import. Read at each call, so a caller may set it between forwards.
OCTIC_PALLAS_LN = os.environ.get("OCTIC_PALLAS_LN", "0") == "1"


def trunc_normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Truncated normal at +-2 std (drawn in f32, then cast)."""
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std, generator=generator)
    with torch.no_grad():
        p.copy_(tmp)


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal (flax ``nn.initializers.normal``), drawn in f32, then cast."""
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.normal_(tmp, std=std, generator=generator)
    with torch.no_grad():
        p.copy_(tmp)


def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.uniform_(tmp, -bound, bound, generator=generator)
    with torch.no_grad():
        p.copy_(tmp)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


def drop_path_d8(xs: tuple, mask: Optional[torch.Tensor]) -> tuple:
    """Stochastic depth with ONE shared per-sample mask across all 5 tuple
    elements (d8_layers.py:drop_path_d8); ``None`` is the identity. The
    packed block applies the same mask to the whole row
    (:meth:`BlockD8._add_branch`)."""
    return xs if mask is None else tuple(x * mask for x in xs)


class DropPathD8(DropPathMask):
    """Drop path of the octic block: one mask on all 5 tuple elements."""

    def forward(self, xs: tuple, mask: Optional[torch.Tensor] = None) -> tuple:
        return drop_path_d8(xs, mask)


class LinearD8(nn.Module):
    """Block-diagonal equivariant linear map: one weight per 1-d irrep
    (``kernel_1d [4, C/8, F/8]``), one E weight applied to each E row
    (``kernel_e [C/4, F/4]``), bias on A1 only. ``use_kernel`` runs it as
    :func:`linear_d8_fused` (K-lin-d8, optionally with the D8-GELU epilogue,
    ``fuse_gelu``), as the flax module's ``use_pallas``; otherwise plain
    torch products (the octic attention's qkv on the train path and its
    proj). ``forward(xs, layerscale, residual)`` returns ``residual + ls *
    linear(xs)`` through the kernel's LayerScale + residual epilogue, the
    flax module's fused block epilogue: the flax proj takes the kernel
    exactly then (``use_pallas=layerscale is not None``), and no JAX block
    hands a LayerScale to a plain linear."""

    def __init__(self, in_features: int, features: int, bias: bool = True, *,
                 use_kernel: bool = False, fuse_gelu: bool = False, device=None, dtype=None):
        super().__init__()
        if fuse_gelu and not use_kernel:
            raise ValueError("fuse_gelu needs use_kernel")
        self.use_kernel = use_kernel
        self.fuse_gelu = fuse_gelu
        if in_features % 8 or features % 8:
            raise ValueError("features must be divisible by 8")
        c8, f8 = in_features // 8, features // 8
        kw = dict(device=device, dtype=dtype)
        self.kernel_1d = _param(4, c8, f8, **kw)
        self.kernel_e = _param(2 * c8, 2 * f8, **kw)
        self.bias_a1 = _param(f8, **kw) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.kernel_1d, 0.02, generator)
        trunc_normal_(self.kernel_e, 0.02, generator)
        if self.bias_a1 is not None:
            nn.init.zeros_(self.bias_a1)

    def forward(self, xs: tuple, layerscale: Optional[tuple] = None,
                residual: Optional[tuple] = None) -> tuple:
        dt = xs[0].dtype
        w1, we, bias = (cast(p, dt) for p in (self.kernel_1d, self.kernel_e, self.bias_a1))
        if layerscale is None:
            if self.use_kernel:
                return linear_d8_fused(xs, w1, we, bias, self.fuse_gelu)
            return linear_d8(xs, w1, we, bias)
        return linear_d8_fused(xs, w1, we, bias, self.fuse_gelu,
                               tuple(cast(t, dt) for t in layerscale),
                               tuple(r.to(dt) for r in residual))


class ScaleD8(nn.Module):
    """Per-irrep diagonal scale (LayerScale), with an optional A1 bias (then
    it is the affine of LayerNormD8). The two E rows share ``alpha_e``."""

    def __init__(self, dim: int, init_value: float = 1.0, bias: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        c8 = dim // 8
        kw = dict(device=device, dtype=dtype)
        self.init_value = init_value
        self.alpha_1d = _param(4, c8, **kw)
        self.alpha_e = _param(2 * c8, **kw)
        self.beta_a1 = _param(c8, **kw) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.alpha_1d, self.init_value)
        nn.init.constant_(self.alpha_e, self.init_value)
        if self.beta_a1 is not None:
            nn.init.zeros_(self.beta_a1)

    def full_width(self, dt: torch.dtype) -> torch.Tensor:
        """The scale over a packed ``[..., C]`` row: ``[alpha_1d | alpha_e |
        alpha_e]`` in `dt` (d8_layers.py:vec_of)."""
        return torch.cat((self.alpha_1d.reshape(-1), self.alpha_e, self.alpha_e)).to(dt)

    def forward(self, xs):
        if isinstance(xs, torch.Tensor):  # the packed container: one full-width pass
            dt = xs.dtype
            if self.beta_a1 is None:
                return xs * self.full_width(dt)
            # beta on the A1 lanes only
            beta = F.pad(self.beta_a1.to(dt), (0, xs.shape[-1] - self.beta_a1.shape[0]))
            return torch.addcmul(beta, xs, self.full_width(dt))
        dt = xs[0].dtype
        a = self.alpha_1d.to(dt)
        oa1 = a[0] * xs[0]
        if self.beta_a1 is not None:
            oa1 = oa1 + self.beta_a1.to(dt)
        ae = self.alpha_e.to(dt)
        ae = torch.cat((ae, ae))
        return (oa1, a[1] * xs[1], a[2] * xs[2], a[3] * xs[3], ae * xs[4])


def layer_norm_d8_stats(xs: tuple, eps: float = 1e-5) -> tuple:
    """Shared-std D8 LayerNorm statistics on the flat-E tuple: per-irrep mean
    removal (each E row its own mean) and one std per token,
    ``std = sqrt(2)/4 * sqrt(var_A1 + var_A2 + var_B1 + var_B2
    + mean_rows(var_E) + eps)`` with biased variances. f32 math, result in
    the input dtype."""
    dt = xs[0].dtype
    ones = [x.float() for x in xs[:4]]
    var = sum(x.var(dim=-1, unbiased=False, keepdim=True) for x in ones)
    e = xs[4].float()
    half = e.shape[-1] // 2
    rows = e.reshape(*e.shape[:-1], 2, half)
    var = var + 0.5 * rows.var(dim=-1, unbiased=False).sum(-1, keepdim=True) + eps
    inv = 1.0 / (SQRT2_OVER_4 * torch.sqrt(var))
    outs = tuple(((x - x.mean(dim=-1, keepdim=True)) * inv).to(dt) for x in ones)
    ec = (rows - rows.mean(dim=-1, keepdim=True)).reshape(e.shape) * inv
    return outs + (ec.to(dt),)


def _slot_means(v: torch.Tensor) -> torch.Tensor:
    """The per-slot means ``[..., 8, 1]`` (f32) of the slot view ``[..., 8,
    C/8]`` of a packed row, the two E-row slots of a row sharing that row's
    mean (slots 4 and 5 are E row 0, 6 and 7 E row 1): the mean removal of
    d8_layers.py:_flat_ln_remove_means, a symmetric idempotent projector,
    used by the forward and the VJP."""
    m8 = v.mean(-1, dtype=torch.float32)
    rows = m8[..., 4:].unflatten(-1, (2, 2)).mean(-1, keepdim=True).expand(*m8.shape[:-1], 2, 2)
    return torch.cat((m8[..., :4], rows.flatten(-2)), dim=-1)[..., None]


def _flat_ln_fwd(x: torch.Tensor, eps: float) -> tuple:
    """(out, xc, var, inv_std) of the D8 LayerNorm statistics on the packed
    ``[..., C]`` container (d8_layers.py:_flat_ln_fwd_impl): f32 math,
    two-pass variance, out in the input dtype; xc is the f32 slot view
    ``[..., 8, C/8]``. Each full-width step is one pass: the means read x, the
    centring writes xc in f32, the moments read it, the scaling writes out."""
    c8 = x.shape[-1] // 8
    v = x.unflatten(-1, (8, c8))
    xc = torch.sub(v, _slot_means(v))  # promotes to f32
    v8 = torch.linalg.vector_norm(xc, dim=-1).square() / c8
    # an E row's variance is the mean of its two slots' moments, and the
    # rows are averaged: 1/4 of the four E-slot moments
    var = v8[..., :4].sum(-1) + 0.25 * v8[..., 4:].sum(-1) + eps
    inv_std = 1.0 / (SQRT2_OVER_4 * torch.sqrt(var))
    out = torch.empty_like(x)
    torch.mul(xc, inv_std[..., None, None], out=out.unflatten(-1, (8, c8)))
    return out, xc, var, inv_std


class _FlatLayerNormD8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        out, xc, var, inv_std = _flat_ln_fwd(x, eps)
        if ctx.needs_input_grad[0]:
            # xc in the stream dtype and two per-token scalars (d8_layers.py:324)
            ctx.save_for_backward(xc.flatten(-2).to(x.dtype), var, inv_std)
        return out

    @staticmethod
    def backward(ctx, u):
        """dx = P [g (u - (u.xc / var) d xc)] with g = inv_std, P the mean
        removal and d the per-lane variance weights (1/c8 on the 1-d lanes,
        0.25/c8 on the E lanes; d8_layers.py:_flat_ln_custom_bwd)."""
        xc_lo, var, inv_std = ctx.saved_tensors
        c8 = xc_lo.shape[-1] // 8
        xc = xc_lo.float().unflatten(-1, (8, c8))
        u32 = u.float().unflatten(-1, (8, c8))
        # built on the device: a tensor from host data would wait for the stream
        d = torch.where(torch.arange(8, device=xc.device)[:, None] < 4, 1.0 / c8, 0.25 / c8)
        coef = ((u32 * xc).sum((-2, -1)) / var)[..., None, None]
        dxc = torch.addcmul(u32, xc, -coef * d).mul_(inv_std[..., None, None])
        dx = torch.empty_like(xc_lo)
        torch.sub(dxc, _slot_means(dxc), out=dx.unflatten(-1, (8, c8)))
        return dx, None


def layer_norm_d8_stats_flat(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """:func:`layer_norm_d8_stats` on the packed ``[..., C]`` container
    (d8_layers.py:layer_norm_d8_stats_flat): per-irrep means (each E row its
    own), one shared sqrt2/4-scaled std per token, eps inside the sqrt.
    Plain torch, as the JAX package computes it in XLA, with the analytic
    VJP of ``OCTIC_FLAT_LN_VJP`` (on by default there) as a
    ``torch.autograd.Function``; the ``[..., 8, C/8]`` slot view is free here."""
    return _FlatLayerNormD8.apply(x, eps)


class LayerNormD8(nn.Module):
    """Equivariant LayerNorm (eps 1e-5): shared-std normalization + ScaleD8
    affine (named ``affine`` as in the flax tree; none without
    `elementwise_affine`, no A1 bias without `use_bias`). A packed ``[...,
    C]`` container takes :func:`layer_norm_d8_stats_flat` and the full-width
    affine (the JAX packed block's apply_norm, never the LN kernel). With `use_kernel`
    and ``OCTIC_PALLAS_LN`` on, the flat-E tuple goes through the LN kernel
    op (d8_layers.py:483-512): :func:`ln_affine_d8_flat_tuple` with the
    affine's parameters as they are (no cast, as the flax module passes
    them), or :func:`ln_d8_flat_tuple` without an affine."""

    def __init__(self, dim: int, *, elementwise_affine: bool = True, use_bias: bool = True,
                 use_kernel: bool = False, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.use_kernel = use_kernel
        self.affine = (ScaleD8(dim, 1.0, bias=use_bias, device=device, dtype=dtype)
                       if elementwise_affine else None)

    def forward(self, xs):
        if isinstance(xs, torch.Tensor):  # the packed container
            y = layer_norm_d8_stats_flat(xs, self.eps)
            return y if self.affine is None else self.affine(y)
        if self.use_kernel and OCTIC_PALLAS_LN and xs[4].ndim == xs[0].ndim:
            a = self.affine
            if a is None:
                return ln_d8_flat_tuple(xs, self.eps)
            beta = (a.beta_a1[None] if a.beta_a1 is not None
                    else a.alpha_1d.new_zeros(1, a.alpha_1d.shape[1]))
            return ln_affine_d8_flat_tuple(xs, a.alpha_1d, _lse_full(a.alpha_e)[None], beta,
                                           self.eps)
        xs = layer_norm_d8_stats(xs, self.eps)
        return xs if self.affine is None else self.affine(xs)


def _expand_lift_kernel(w: torch.Tensor, irrep: str) -> torch.Tensor:
    """Fold a quadrant kernel ``[kh/2, kw/2, I, O]`` out to the full
    symmetrized ``[kh, kw, I, O]`` kernel of one irrep."""
    if irrep == "E":
        half = 0.5 * w
        col = torch.cat([half, torch.flip(half, (0,))], dim=0)
        return torch.cat([col, -torch.flip(col, (1,))], dim=1)
    q = SQRT2_OVER_4 * w
    sign = -1.0 if irrep in ("B1", "B2") else 1.0
    rot = lambda k: torch.rot90(q, k=k, dims=(0, 1))  # noqa: E731
    left = torch.cat([q, sign * rot(1)], dim=0)
    right = torch.cat([sign * rot(3), rot(2)], dim=0)
    full = torch.cat([left, right], dim=1)
    flipped = torch.flip(full, (1,))
    return full + flipped if irrep in ("A1", "B1") else full - flipped


def _patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC image -> ``[B, gh, gw, p*p*C]`` patches (row-major (pi, pj, c))."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh, gw, patch * patch * c)


class PatchEmbedD8(nn.Module):
    """Lifting patch embed of RGB images: six symmetrized stride-p
    convolutions (A1 with bias, A2, B1, B2, E-left, E-right; each E kernel is
    applied twice, once rotated) as one patchify + matmul, producing the
    flat-E tuple."""

    IRREP_PARAMS = ("w_a1", "w_a2", "w_b1", "w_b2", "w_e_left", "w_e_right")

    def __init__(self, patch_size: int, embed_dim: int, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % 8:
            raise ValueError("embed_dim must be divisible by 8")
        if patch_size % 2:
            raise NotImplementedError("odd patch sizes are not supported")
        self.patch_size = patch_size
        self.out8 = embed_dim // 8
        quad = (patch_size // 2, patch_size // 2, 3, self.out8)
        self.fan_in = quad[0] * quad[1] * 3
        kw = dict(device=device, dtype=dtype)
        for name in self.IRREP_PARAMS:
            setattr(self, name, _param(*quad, **kw))
        self.bias_a1 = _param(self.out8, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        for name in self.IRREP_PARAMS + ("bias_a1",):
            uniform_(getattr(self, name), bound, generator)

    def lifted_matrix(self) -> torch.Tensor:
        """``[p*p*C_in, 8*C/8]`` weight in isotypic slot order
        (A1 A2 B1 B2 E11 E21 E12 E22)."""
        kernels = [_expand_lift_kernel(getattr(self, f"w_{i.lower()}"), i)
                   for i in ("A1", "A2", "B1", "B2")]
        for side in ("w_e_left", "w_e_right"):
            ke = _expand_lift_kernel(getattr(self, side), "E")
            kernels += [ke, torch.rot90(ke, k=1, dims=(0, 1))]
        kernel = torch.cat(kernels, dim=-1)
        return kernel.reshape(-1, 8 * self.out8)

    def forward(self, x: torch.Tensor) -> tuple:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % (2 * p) or w % (2 * p):
            raise ValueError(f"image ({h}x{w}) must be an even multiple of patch size {p}")
        mat = self.lifted_matrix().to(x.dtype)
        feats = torch.matmul(_patchify(x, p), mat)
        feats = feats.reshape(b, (h // p) * (w // p), 8, self.out8)
        feats = torch.cat((feats[..., :1, :] + self.bias_a1.to(x.dtype), feats[..., 1:, :]),
                          dim=-2)
        return pack_8_to_5f(tuple(feats[..., i, :] for i in range(8)))


class GeluD8(nn.Module):
    """The octic GELU (d8_layers.py:566): the kernel op :func:`gelu_d8` with
    `use_kernel` (the flax ``use_pallas``), else the plain composite."""

    def __init__(self, use_kernel: bool = False):
        super().__init__()
        self.use_kernel = use_kernel

    def forward(self, xs: tuple) -> tuple:
        return gelu_d8(xs) if self.use_kernel else gelu_d8_eager(xs)


class MlpD8(nn.Module):
    """fc1 -> D8 GELU -> fc2 (d8_layers.py:603-681).

    With ``use_pallas_linear`` (the port's default, the bench and train
    flags) and without a LayerScale epilogue, it runs the fused octic MLP op
    in eval mode (the bench flags' ``fuse_mlp``) and, with ``fuse_mlp``, in
    train mode too (differentiable: row 4's backward); a packed ``[..., C]``
    input then takes the packed op :func:`mlp_d8_packed` and comes back
    packed. Otherwise a packed input is unpacked to its flat-E views (as the
    JAX module does) and fc1 and fc2 are two :func:`linear_d8_fused`
    kernels, fc1 with the D8-GELU epilogue, as the JAX train configuration
    runs them, and fc2 takes the LayerScale + residual epilogue where
    ``forward`` gets `layerscale` and `residual`. Without
    ``use_pallas_linear``, fc1 and fc2 are plain products around
    :class:`GeluD8`, the GELU kernel op with ``use_pallas_gelu``. The hidden
    is rounded to the working dtype between them."""

    def __init__(self, in_features: int, hidden_features: int, bias: bool = True, *,
                 use_pallas_linear: bool = True, use_pallas_gelu: bool = False,
                 fuse_mlp: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_pallas_linear = use_pallas_linear
        self.fuse_mlp = fuse_mlp
        self.fc1 = LinearD8(in_features, hidden_features, bias, use_kernel=use_pallas_linear,
                            fuse_gelu=use_pallas_linear, **kw)
        self.gelu = GeluD8(use_pallas_gelu)
        self.fc2 = LinearD8(hidden_features, in_features, bias, use_kernel=use_pallas_linear,
                            **kw)

    def forward(self, xs, layerscale: Optional[tuple] = None, residual: Optional[tuple] = None):
        packed = isinstance(xs, torch.Tensor)
        if not (self.use_pallas_linear and layerscale is None
                and (self.fuse_mlp or not self.training)):
            if packed:
                xs = unpack_packed_5f(xs)
            h = self.fc1(xs)
            if not self.use_pallas_linear:
                h = self.gelu(h)
            return self.fc2(h, layerscale, residual)
        dt = xs.dtype if packed else xs[0].dtype
        f1, f2 = self.fc1, self.fc2
        params = tuple(cast(p, dt) for p in (f1.kernel_1d, f1.kernel_e, f1.bias_a1, f2.kernel_1d,
                                             f2.kernel_e, f2.bias_a1))
        return mlp_d8_packed(xs, *params) if packed else mlp_d8_fused(xs, *params)


class AttentionD8(nn.Module):
    """Equivariant multi-head attention. In eval mode (the bench flags) the
    qkv LinearD8 and the softmax attention run in the fused qkv + attention
    op. In train mode with ``fuse_qkv`` (the DINOv2 flags) they run in the
    same op, whose backward recomputes the qkv; without it (the DeiT III
    flags) the qkv is a plain LinearD8 (:meth:`qkv_arrays`), then
    :func:`octic_attention`, which takes the two E rows of the flat-E qkv as
    column slices. With ``use_wide_qkv`` (d8_layers.py:929-1008; it takes
    precedence over both, in either mode) the qkv is the wide-1d product
    :func:`linear_d8_wide1d`, then :func:`octic_attention_wide1d`; the
    parameters are the same. The proj is a plain LinearD8 (:meth:`project`).
    A packed ``[B, N, C]`` input takes the packed fused op
    (:func:`octic_attention_fused_qkv_packed`) where the fused op runs, and
    is unpacked to its flat-E views otherwise (d8_layers.py:895-909)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, proj_bias: bool = True,
                 fuse_qkv: bool = False, use_wide_qkv: bool = False, *, device=None, dtype=None):
        super().__init__()
        if (dim // num_heads) % 8:
            raise ValueError("head dim must be divisible by 8")
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.fuse_qkv = fuse_qkv
        self.use_wide_qkv = use_wide_qkv
        self.qkv = LinearD8(dim, 3 * dim, qkv_bias, **kw)
        self.proj = LinearD8(dim, dim, proj_bias, **kw)

    def qkv_arrays(self, xs) -> tuple:
        """The attention kernel's inputs of the normed input (the flat-E
        tuple or the packed container, unpacked here): the ``attn_in`` the
        flax module tags for remat. The six of :func:`octic_attention` (a1..b2
        ``[B, N, 3C/8]``, e0, e1 ``[B, N, 3C/4]`` as views of the flat-E qkv),
        or with ``use_wide_qkv`` the five of :func:`octic_attention_wide1d`."""
        if isinstance(xs, torch.Tensor):
            xs = unpack_packed_5f(xs)
        if self.use_wide_qkv:
            q = self.qkv
            params = tuple(cast(p, xs[0].dtype) for p in (q.kernel_1d, q.kernel_e, q.bias_a1))
            return linear_d8_wide1d(xs, *params, self.num_heads)
        qkv = self.qkv(xs)
        half = qkv[4].shape[-1] // 2
        return qkv[:4] + (qkv[4][..., :half], qkv[4][..., half:])

    def attention(self, inputs: tuple) -> tuple:
        """The attention kernel over :meth:`qkv_arrays`' output."""
        op = octic_attention_wide1d if self.use_wide_qkv else octic_attention
        return op(*inputs, self.num_heads)

    def attend(self, xs) -> tuple:
        """The six attention outputs (``attn_out``) of the normed input (the
        flat-E tuple or the packed container)."""
        if self.use_wide_qkv or (self.training and not self.fuse_qkv):
            return self.attention(self.qkv_arrays(xs))
        packed = isinstance(xs, torch.Tensor)
        dt = xs.dtype if packed else xs[0].dtype
        q = self.qkv
        params = tuple(cast(p, dt) for p in (q.kernel_1d, q.kernel_e, q.bias_a1))
        if packed:
            return octic_attention_fused_qkv_packed(xs, *params, self.num_heads)
        return octic_attention_fused_qkv(*xs, *params, self.num_heads)

    def project(self, outs: tuple, layerscale: Optional[tuple] = None,
                residual: Optional[tuple] = None) -> tuple:
        """The proj of the six attention outputs; with `layerscale` and
        `residual`, ``residual + ls * proj(...)`` through the kernel's
        epilogue (d8_layers.py:1055-1058, the proj's ``use_pallas=layerscale
        is not None``)."""
        o1, o2, o3, o4, oe0, oe1 = outs
        return self.proj((o1, o2, o3, o4, torch.cat((oe0, oe1), dim=-1)), layerscale, residual)

    def forward(self, xs: tuple, layerscale: Optional[tuple] = None,
                residual: Optional[tuple] = None) -> tuple:
        return self.project(self.attend(xs), layerscale, residual)


class BlockD8(nn.Module):
    """Pre-norm equivariant transformer block with LayerScale (``ls1``,
    ``ls2``) and drop path: the DeiT III block, and the DINOv2 block with
    ``fuse_qkv``. ``forward(xs, masks, remat_block)``: `masks` are the two
    drop-path masks from :meth:`draw_masks` (or None); with `remat_block`
    the proj ... MLP half is rematerialized, and so is the half before the
    attention kernel: norm1 + qkv, or norm1 alone when the fused qkv +
    attention op takes the normed input (its forward is not replayed: the
    normed input it saves and its six outputs are what remat keeps).

    The fused-glue options, with the JAX conditions and precedence
    (d8_layers.py:1219-1269): ``fuse_block_epilogues`` (with
    ``use_pallas_linear``, and no drop path or eval mode) writes ``x + ls *
    y`` in the proj's and fc2's kernel epilogues; otherwise
    ``fuse_mlp_branch`` (the same conditions) runs norm2 ... ls2 + residual
    as :func:`mlp_branch_d8`. ``use_pallas_linear`` and ``use_pallas_gelu``
    go to the MLP, and so does ``fuse_mlp``.

    With the packed ``[B, N, C]`` container as `xs` (``packed_carry``,
    d8_layers.py:1289-1353) the block returns the container: the norms run
    on it as full-width passes, and each branch's LayerScale, drop path (one
    mask per sample over the whole row) and residual add as one multiply-add;
    the attention and the MLP take the packed ops where they run fused, and
    the tuple-only fusions (epilogues, MLP branch) stay off, as in JAX.
    Remat as above: the packed normed input is what the fused op saves.

    ``use_wide_qkv`` goes to the attention (d8_layers.py:1181, :1252): under
    remat norm1 + the wide-1d qkv product are rematerialized and
    :func:`octic_attention_wide1d` saves their five outputs; a packed
    container is unpacked to its flat-E views for the qkv, as the JAX layer
    does."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layerscale_init: float = 1e-4,
                 drop_path: float = 0.0, proj_bias: bool = True, ffn_bias: bool = True,
                 fuse_qkv: bool = False, use_pallas_linear: bool = True,
                 use_pallas_gelu: bool = False, fuse_block_epilogues: bool = False,
                 fuse_mlp_branch: bool = False, fuse_mlp: bool = False,
                 use_wide_qkv: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_pallas_linear = use_pallas_linear
        self.fuse_block_epilogues = fuse_block_epilogues
        self.fuse_mlp_branch = fuse_mlp_branch
        self.norm1 = LayerNormD8(dim, use_kernel=True, **kw)
        self.attn = AttentionD8(dim, num_heads, qkv_bias, proj_bias, fuse_qkv, use_wide_qkv,
                                **kw)
        self.ls1 = ScaleD8(dim, layerscale_init, **kw)
        self.drop_path1 = DropPathD8(drop_path)
        self.norm2 = LayerNormD8(dim, use_kernel=True, **kw)
        self.mlp = MlpD8(dim, int(dim * mlp_ratio), ffn_bias, use_pallas_linear=use_pallas_linear,
                         use_pallas_gelu=use_pallas_gelu, fuse_mlp=fuse_mlp, **kw)
        self.ls2 = ScaleD8(dim, layerscale_init, **kw)
        self.drop_path2 = DropPathD8(drop_path)

    def _no_drop_path(self) -> bool:
        return self.drop_path1.rate == 0.0 or not self.training

    def fuse_epilogue(self) -> bool:
        """Whether this call writes the residual adds in the kernel epilogues."""
        return self.fuse_block_epilogues and self.use_pallas_linear and self._no_drop_path()

    def fuse_branch(self) -> bool:
        """Whether this call runs the MLP half as :func:`mlp_branch_d8`."""
        return (self.fuse_mlp_branch and self.use_pallas_linear and self._no_drop_path()
                and not self.fuse_epilogue())

    def branch_params(self, dt: torch.dtype) -> tuple:
        """The 11-tuple of :func:`mlp_branch_d8` from norm2, the MLP and ls2,
        cast to `dt` (zeros where a bias is off)."""
        na, f1, f2 = self.norm2.affine, self.mlp.fc1, self.mlp.fc2

        def vec(p, n):
            return cast(p, dt) if p is not None else torch.zeros(n, device=na.alpha_1d.device,
                                                                 dtype=dt)

        return (cast(na.alpha_1d, dt), cast(na.alpha_e, dt), vec(na.beta_a1, na.alpha_1d.shape[1]),
                cast(f1.kernel_1d, dt), cast(f1.kernel_e, dt), vec(f1.bias_a1, f1.kernel_1d.shape[2]),
                cast(f2.kernel_1d, dt), cast(f2.kernel_e, dt), vec(f2.bias_a1, f2.kernel_1d.shape[2]),
                cast(self.ls2.alpha_1d, dt), cast(self.ls2.alpha_e, dt))

    def draw_masks(self, batch: int, generator: Optional[torch.Generator], *, device=None,
                   dtype=None) -> tuple:
        kw = dict(device=device, dtype=dtype)
        return (self.drop_path1.draw(batch, generator, **kw),
                self.drop_path2.draw(batch, generator, **kw))

    def _normed(self, *xs):
        """norm1 of the flat-E tuple `xs`, or of the packed container ``xs[0]``."""
        return self.norm1(xs[0] if len(xs) == 1 else xs)

    def _attn_in(self, *xs) -> tuple:
        return self.attn.qkv_arrays(self._normed(*xs))

    def _attn_out(self, *args) -> tuple:
        xs, outs, (m1, m2) = args[:5], args[5:11], args[11:]
        if self.fuse_epilogue():
            xs = self.attn.project(outs, (self.ls1.alpha_1d, self.ls1.alpha_e), xs)
            return self.mlp(self.norm2(xs), (self.ls2.alpha_1d, self.ls2.alpha_e), xs)
        ys = self.drop_path1(self.ls1(self.attn.project(outs)), m1)
        xs = tuple(x + y for x, y in zip(xs, ys))
        if self.fuse_branch():
            return mlp_branch_d8(xs, self.branch_params(xs[0].dtype))
        ys = self.drop_path2(self.ls2(self.mlp(self.norm2(xs))), m2)
        return tuple(x + y for x, y in zip(xs, ys))

    @staticmethod
    def _add_branch(x: torch.Tensor, y: torch.Tensor, ls: ScaleD8,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
        """``x + drop_path(ls(y))`` on the packed container in one full-width
        pass: the LayerScale vector times the per-sample mask, then one
        multiply-add."""
        a = ls.full_width(x.dtype)
        return torch.addcmul(x, y, a if mask is None else a * mask)

    def _attn_out_packed(self, x: torch.Tensor, *args) -> torch.Tensor:
        outs, (m1, m2) = args[:6], args[6:]
        x = self._add_branch(x, pack_5_to_flat(self.attn.project(outs)), self.ls1, m1)
        ys = self.mlp(self.norm2(x))
        if not isinstance(ys, torch.Tensor):
            ys = pack_5_to_flat(ys)
        return self._add_branch(x, ys, self.ls2, m2)

    def forward(self, xs, masks: tuple = (None, None), remat_block: bool = False):
        packed = isinstance(xs, torch.Tensor)
        xs = (xs,) if packed else tuple(xs)
        out_fn = self._attn_out_packed if packed else self._attn_out
        if not remat_block:
            return out_fn(*xs, *self.attn.attend(self._normed(*xs)), *masks)
        if self.attn.fuse_qkv and not self.attn.use_wide_qkv:
            outs = self.attn.attend(remat(self._normed, *xs))
        else:
            outs = self.attn.attention(remat(self._attn_in, *xs))
        return remat(out_fn, *xs, *outs, *masks)
