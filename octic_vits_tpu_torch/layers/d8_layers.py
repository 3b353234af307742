"""D8-equivariant ViT layers as torch ``nn.Module``s, eval-mode forward on
the flat-E 5-tuple ``(a1, a2, b1, b2, ef)`` (a* ``[B, N, C/8]``,
``ef [B, N, C/2] = [row0 | row1]``).

Counterpart of the inference paths of octic_vits_tpu/layers/d8_layers.py
that the benchmark flags reach (flat-E carry, fused qkv + attention, fused
MLP). Parameter names and shapes follow the flax tree so
:func:`octic_vits_tpu_torch.utils.convert.params_from_jax` maps them one to
one; every module takes an explicit ``device`` and ``dtype`` and is filled by
``reset_parameters(generator)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from octic_vits_tpu_torch.d8.group import SQRT2_OVER_4, pack_8_to_5f
from octic_vits_tpu_torch.ops.attention import octic_attention_fused_qkv
from octic_vits_tpu_torch.ops.linear import linear_d8, mlp_d8_fused


def trunc_normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Truncated normal at +-2 std (drawn in f32, then cast)."""
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std, generator=generator)
    with torch.no_grad():
        p.copy_(tmp)


def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    tmp = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    nn.init.uniform_(tmp, -bound, bound, generator=generator)
    with torch.no_grad():
        p.copy_(tmp)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class LinearD8(nn.Module):
    """Block-diagonal equivariant linear map: one weight per 1-d irrep
    (``kernel_1d [4, C/8, F/8]``), one E weight applied to each E row
    (``kernel_e [C/4, F/4]``), bias on A1 only. Plain torch products: in the
    slice this is the octic attention's proj; qkv and the MLP read its
    parameters and run them in the kernels."""

    def __init__(self, in_features: int, features: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
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

    def forward(self, xs: tuple) -> tuple:
        return linear_d8(xs, self.kernel_1d, self.kernel_e, self.bias_a1)


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

    def forward(self, xs: tuple) -> tuple:
        a = self.alpha_1d
        oa1 = a[0] * xs[0]
        if self.beta_a1 is not None:
            oa1 = oa1 + self.beta_a1
        ae = torch.cat((self.alpha_e, self.alpha_e))
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


class LayerNormD8(nn.Module):
    """Equivariant LayerNorm (eps 1e-5): shared-std normalization + ScaleD8
    affine (named ``affine`` as in the flax tree)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.affine = ScaleD8(dim, 1.0, bias=True, device=device, dtype=dtype)

    def forward(self, xs: tuple) -> tuple:
        return self.affine(layer_norm_d8_stats(xs))


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
        mat = self.lifted_matrix()
        feats = torch.matmul(_patchify(x.to(mat.dtype), p), mat)
        feats = feats.reshape(b, (h // p) * (w // p), 8, self.out8)
        feats = torch.cat((feats[..., :1, :] + self.bias_a1, feats[..., 1:, :]), dim=-2)
        return pack_8_to_5f(tuple(feats[..., i, :] for i in range(8)))


class MlpD8(nn.Module):
    """fc1 -> D8 GELU -> fc2 through the fused octic MLP op (hidden rounded
    to the working dtype between the two products)."""

    def __init__(self, in_features: int, hidden_features: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = LinearD8(in_features, hidden_features, **kw)
        self.fc2 = LinearD8(hidden_features, in_features, **kw)

    def forward(self, xs: tuple) -> tuple:
        f1, f2 = self.fc1, self.fc2
        return mlp_d8_fused(xs, f1.kernel_1d, f1.kernel_e, f1.bias_a1,
                            f2.kernel_1d, f2.kernel_e, f2.bias_a1)


class AttentionD8(nn.Module):
    """Equivariant multi-head attention: the qkv LinearD8 and the softmax
    attention run in the fused qkv + attention op; the proj is a LinearD8."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        if (dim // num_heads) % 8:
            raise ValueError("head dim must be divisible by 8")
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qkv = LinearD8(dim, 3 * dim, qkv_bias, **kw)
        self.proj = LinearD8(dim, dim, **kw)

    def forward(self, xs: tuple) -> tuple:
        q = self.qkv
        o1, o2, o3, o4, oe0, oe1 = octic_attention_fused_qkv(
            *xs, q.kernel_1d, q.kernel_e, q.bias_a1, self.num_heads)
        return self.proj((o1, o2, o3, o4, torch.cat((oe0, oe1), dim=-1)))


class BlockD8(nn.Module):
    """Pre-norm equivariant transformer block with LayerScale (``ls1``,
    ``ls2``), the DeiT III block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layerscale_init: float = 1e-4, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNormD8(dim, **kw)
        self.attn = AttentionD8(dim, num_heads, qkv_bias, **kw)
        self.ls1 = ScaleD8(dim, layerscale_init, **kw)
        self.norm2 = LayerNormD8(dim, **kw)
        self.mlp = MlpD8(dim, int(dim * mlp_ratio), **kw)
        self.ls2 = ScaleD8(dim, layerscale_init, **kw)

    def forward(self, xs: tuple) -> tuple:
        ys = self.ls1(self.attn(self.norm1(xs)))
        xs = tuple(x + y for x, y in zip(xs, ys))
        ys = self.ls2(self.mlp(self.norm2(xs)))
        return tuple(x + y for x, y in zip(xs, ys))
