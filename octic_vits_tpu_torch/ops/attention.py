"""Multi-head attention for ViT shapes, reading the producer's natural
layout (counterpart of octic_vits_tpu/ops/pallas_attention.py).

* :func:`standard_attention`: qkv ``[B, N, 3C]`` in (3, H, dh) column
  order -> ``[B, N, C]``.
* :func:`octic_attention_fused_qkv`: the flat-E tuple after the norm plus
  the block-diagonal qkv weights -> the attention outputs in irrep layout.
  Head h's dh = C/H channels are a1|a2|b1|b2 (d1 = C/(8H) each) and the two
  E rows (de = C/(4H) each); the scale is dh^-0.5, as in the standard case.
"""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.linear import lin_d8_launch, linear_d8

MAX_HEAD_DIM = 128  # the kernel's widest instantiation (csrc/attention.cu)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100


def _check_attention_shape(n: int, dh: int) -> None:
    """The kernel keeps a whole head's q, k and v^T in shared memory."""
    kpad, dhp = -(-n // 16) * 16, -(-dh // 16) * 16
    smem = (2 * kpad * (dhp + 8) + dhp * (kpad + 8)) * 2 + 2 * dhp
    if dh % 8 or dh > MAX_HEAD_DIM or smem > SMEM_LIMIT:
        raise ValueError(f"attention kernel: N={n}, head dim {dh} unsupported "
                         f"(head dim a multiple of 8 up to {MAX_HEAD_DIM}; "
                         f"{smem} bytes of shared memory needed, {SMEM_LIMIT} available)")


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v ``[B, N, H, dh]`` (f32) -> ``[B, N, H, dh]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def standard_attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version: f32 math, result in ``qkv.dtype``."""
    b, n, w = qkv.shape
    c = w // 3
    q, k, v = qkv.float().reshape(b, n, 3, num_heads, c // num_heads).unbind(2)
    return _softmax_attention(q, k, v).reshape(b, n, c).to(qkv.dtype)


def standard_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(dh)) V per (batch, head). CPU tensors take
    :func:`standard_attention_reference`; CUDA tensors launch K-attn
    (csrc/attention.cu) in its standard head layout."""
    if not on_cuda((qkv,)):
        return standard_attention_reference(qkv, num_heads)
    b, n, w = qkv.shape
    c = w // 3
    dh = c // num_heads
    if w != 3 * c or c != num_heads * dh:
        raise ValueError(f"standard_attention: width {w} with {num_heads} heads unsupported")
    _check_attention_shape(n, dh)
    check_kernel_arg(qkv, "qkv", (b, n, w))
    out = torch.empty(b, n, c, device=qkv.device, dtype=qkv.dtype)
    standard_attention.launches += 1
    kernels.launch("ovt_attention_std", qkv, out, b, n, num_heads, dh)
    return out


standard_attention.launches = 0


def _octic_heads(qkv5: tuple, num_heads: int, s: int) -> torch.Tensor:
    """Head-assembled q (s=0), k (1) or v (2) ``[B, N, H, dh]`` from the qkv
    5-tuple (1-d arrays ``[B, N, 3C/8]``, flat E ``[B, N, 3C/2]``)."""
    b, n, w1 = qkv5[0].shape
    d1 = w1 // (3 * num_heads)
    rows = qkv5[4].reshape(b, n, 2, 3, num_heads, 2 * d1)
    parts = [t.reshape(b, n, 3, num_heads, d1)[:, :, s] for t in qkv5[:4]]
    parts += [rows[:, :, 0, s], rows[:, :, 1, s]]
    return torch.cat(parts, dim=-1)


def octic_attention_fused_qkv_reference(a1, a2, b1, b2, ef, w1, we,
                                        bias: Optional[torch.Tensor],
                                        num_heads: int) -> tuple:
    """Plain version: the qkv LinearD8 in f32, rounded to the input dtype
    where the kernel stores it, then f32 attention."""
    dt = a1.dtype
    xs = tuple(t.float() for t in (a1, a2, b1, b2, ef))
    qkv = linear_d8(xs, w1.float(), we.float(), None if bias is None else bias.float())
    qkv = tuple(t.to(dt).float() for t in qkv)
    q, k, v = (_octic_heads(qkv, num_heads, s) for s in range(3))
    o = _softmax_attention(q, k, v)  # [B, N, H, dh]
    b, n, c8 = a1.shape
    d1 = c8 // num_heads
    de = 2 * d1
    outs = tuple(o[..., g * d1:(g + 1) * d1].reshape(b, n, c8) for g in range(4))
    oes = tuple(o[..., 4 * d1 + r * de:4 * d1 + (r + 1) * de].reshape(b, n, 2 * c8)
                for r in range(2))
    return tuple(t.to(dt) for t in outs + oes)


def octic_attention_fused_qkv(a1, a2, b1, b2, ef, w1, we, bias: Optional[torch.Tensor],
                              num_heads: int) -> tuple:
    """Flat-E tuple (a1..b2 ``[B, N, C/8]``, ef ``[B, N, C/2]``) and qkv
    weights (w1 ``[4, C/8, 3C/8]``, we ``[C/4, 3C/4]``, A1 bias ``[3C/8]``)
    -> ``(o1, o2, o3, o4 [B, N, C/8], oe0, oe1 [B, N, C/4])``.

    CPU tensors take the reference; CUDA tensors launch K-lin-d8 (the qkv
    5-tuple, no epilogue) and then K-attn in its octic head layout."""
    if not on_cuda((a1, a2, b1, b2, ef, w1, we, bias)):
        return octic_attention_fused_qkv_reference(a1, a2, b1, b2, ef, w1, we, bias, num_heads)
    b, n, c8 = a1.shape
    if c8 % num_heads:
        raise ValueError(f"octic_attention_fused_qkv: C={8 * c8} with {num_heads} heads unsupported")
    if tuple(w1.shape) != (4, c8, 3 * c8):
        raise ValueError(f"octic_attention_fused_qkv: w1 {tuple(w1.shape)}, "
                         f"expected {(4, c8, 3 * c8)}")
    d1 = c8 // num_heads
    _check_attention_shape(n, 8 * d1)
    octic_attention_fused_qkv.launches += 1
    qkv = lin_d8_launch((a1, a2, b1, b2, ef), w1, we, bias, gelu=False)
    kw = dict(device=a1.device, dtype=a1.dtype)
    outs = tuple(torch.empty(b, n, c8, **kw) for _ in range(4))
    oes = tuple(torch.empty(b, n, 2 * c8, **kw) for _ in range(2))
    kernels.launch("ovt_attention_octic", *qkv, *outs, *oes, b, n, num_heads, d1, 2 * d1)
    return outs + oes


octic_attention_fused_qkv.launches = 0
