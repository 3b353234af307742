"""The tile sweep of K-lin-d8's mma.sync core (kernel row 14b,
``scripts/profile_lin_tiles.py``): the qkv LinearD8 at other CTA tiles than
the 64 tokens x 32 channels that the model paths ran before K-lin-d8's TMA +
wgmma redesign, through ``csrc/lin_d8_probe.cu``, which runs that core's
device code (``csrc/lin_d8_core.cuh``); and :func:`lin_d8_sync`, that core at
64 x 32 with every epilogue and store, the yardstick the redesigned K-lin-d8
(``csrc/lin_d8.cu``) is timed against.

The TPU script times ``pallas_linear.py``'s ``_kernel`` (the tuple store,
``call_tuple``) and ``_wide_kernel`` (the grouped-column wide store of row
13b, ``call_wide``) at token tiles tm = 128 ... 1024. An H100 CTA's tile has
two sides, tokens (BM) and channels (BN, across all eight slots), bounded by
227 KB of shared memory: :data:`TILES` are the ones the kernel's warp layout
admits. The tile changes no output's summation order, so every tile gives
the bits of the core's 64 x 32 instantiation (:func:`lin_d8_sync`). CPU tensors take the reference; CUDA tensors launch the
kernel. The op runs on no model path.
"""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.attention import SMEM_LIMIT
from octic_vits_tpu_torch.ops.linear import (
    _check_tuple,
    _row_strides,
    _wide_dims,
    linear_d8_fused_reference,
    linear_d8_qkv_wide_reference,
)

#: the (BM, BN) tiles csrc/lin_d8_probe.cu instantiates; (64, 32) is K-lin-d8's
TILES = ((32, 32), (64, 32), (128, 32), (64, 64))
STORES = ("tuple", "wide")


def lin_d8_tile_smem(bm: int, bn: int) -> int:
    """Dynamic shared memory of one CTA at tile bm x bn
    (csrc/lin_d8_core.cuh:Tile::SMEM_BYTES): the 2-stage operand pipeline or
    the epilogue's f32 staging, whichever is larger."""
    pipe = 2 * (6 * bm * 40 + 6 * 32 * (bn + 8)) * 2
    return max(pipe, 8 * bm * (bn + 4) * 4)


def _check(x1, xef, w1, we, bm, bn, store, num_heads):
    if store not in STORES:
        raise ValueError(f"lin_d8_tiled: store {store!r} is not one of {STORES}")
    if (bm, bn) not in TILES:
        smem = lin_d8_tile_smem(bm, bn)
        raise ValueError(f"lin_d8_tiled: tile {bm}x{bn} is not built (tiles {TILES}; it needs "
                         f"{smem} bytes of shared memory, {SMEM_LIMIT} available)")
    if x1.ndim != 3 or x1.shape[0] != 4 or w1.ndim != 3 or w1.shape[0] != 4:
        raise ValueError(f"lin_d8_tiled: x1 {tuple(x1.shape)}, w1 {tuple(w1.shape)} are not "
                         "[4, M, C], [4, C, F]")
    _, m, c = x1.shape
    f = w1.shape[2]
    if tuple(xef.shape) != (m, 4 * c) or tuple(w1.shape) != (4, c, f) or tuple(we.shape) != (
            2 * c, 2 * f):
        raise ValueError("lin_d8_tiled: xef [M, 4C], w1 [4, C, F] and we [2C, 2F] disagree")
    if store == "wide":
        if num_heads is None:
            raise ValueError("lin_d8_tiled: the wide store needs num_heads")
        _wide_dims(f, num_heads)
    return m, c, f


def lin_d8_tiled_reference(x1, xef, w1, we, *, bm: int, bn: int, store: str,
                           num_heads: Optional[int] = None):
    """The plain versions: ``linear_d8_fused``'s (tuple store: y1 ``[4, M,
    F]``, yef ``[M, 4F]``) and ``linear_d8_qkv_wide``'s (``[M, 8F]``); no
    bias. The tile does not enter."""
    _check(x1, xef, w1, we, bm, bn, store, num_heads)
    if store == "wide":
        return linear_d8_qkv_wide_reference(x1, xef, w1, we, None, num_heads)
    y = linear_d8_fused_reference(tuple(x1) + (xef,), w1, we, None)
    return torch.stack(y[:4]), y[4]


def lin_d8_tiled(x1: torch.Tensor, xef: torch.Tensor, w1: torch.Tensor, we: torch.Tensor, *,
                 bm: int, bn: int, store: str, num_heads: Optional[int] = None):
    """The qkv LinearD8 (no bias, no epilogue) at CTA tile ``bm x bn``: x1
    ``[4, M, C]``, xef ``[M, 4C]``, w1 ``[4, C, F]``, we ``[2C, 2F]`` -> the
    tuple store ``(y1 [4, M, F], yef [M, 4F])`` (profile_lin_tiles.py:
    call_tuple) or, with ``store="wide"``, the interleaved qkv ``[M, 8F]``
    of ``num_heads`` heads (call_wide)."""
    m, c, f = _check(x1, xef, w1, we, bm, bn, store, num_heads)
    if not on_cuda((x1, xef, w1, we)):
        return lin_d8_tiled_reference(x1, xef, w1, we, bm=bm, bn=bn, store=store,
                                      num_heads=num_heads)
    if c % 8 or f % 8:
        raise ValueError(f"lin_d8_tiled: widths c={c}, f={f} must be multiples of 8")
    check_kernel_arg(x1, "x1", (4, m, c))
    check_kernel_arg(xef, "xef", (m, 4 * c))
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    kw = dict(device=x1.device, dtype=x1.dtype)
    if store == "wide":
        d1, de = _wide_dims(f, num_heads)
        y = torch.empty(m, 8 * f, **kw)
        ys, yes = tuple(y[:, g * d1:] for g in range(4)), (y[:, 4 * d1:], y[:, 4 * d1 + de:])
        lds, groups, out = (8 * f, 8 * f), (d1, 8 * d1, de, 8 * d1), y
    else:
        y1, yef = torch.empty(4, m, f, **kw), torch.empty(m, 4 * f, **kw)
        ys, yes = tuple(y1), (yef, yef[:, 2 * f:])
        lds, groups, out = (f, 4 * f), (f, 0, 2 * f, 0), (y1, yef)
    lin_d8_tiled.launches += 1
    kernels.launch("ovt_lin_d8_tiled", *x1, xef, w1, we, None, *ys, *yes, m, c, f, c, 4 * c,
                   *lds, *groups, bm, bn)
    return out


lin_d8_tiled.launches = 0
lin_d8_tiled.reference = lin_d8_tiled_reference


def lin_d8_sync_reference(xs: tuple, w1, we, bias: Optional[torch.Tensor], gelu: bool = False,
                          layerscale: Optional[tuple] = None, residual: Optional[tuple] = None,
                          num_heads: Optional[int] = None):
    """The plain versions: :func:`~octic_vits_tpu_torch.ops.linear.linear_d8_fused`'s
    (the flat-E 5-tuple) or, with ``num_heads``, ``linear_d8_qkv_wide``'s."""
    if num_heads is not None:
        return linear_d8_qkv_wide_reference(torch.stack(tuple(xs[:4])), xs[4], w1, we, bias,
                                            num_heads)
    return linear_d8_fused_reference(tuple(xs), w1, we, bias, gelu, layerscale, residual)


def lin_d8_sync(xs: tuple, w1, we, bias: Optional[torch.Tensor], gelu: bool = False,
                layerscale: Optional[tuple] = None, residual: Optional[tuple] = None,
                num_heads: Optional[int] = None):
    """K-lin-d8 on its mma.sync core at 64 x 32 (csrc/lin_d8_probe.cu:
    ovt_lin_d8_sync), the kernel the model paths ran before the TMA + wgmma
    redesign: the flat-E tuple ``xs``, the weights and an A1 bias, with the
    D8-GELU epilogue, the LayerScale + residual epilogue, or neither -> the
    flat-E 5-tuple; with ``num_heads``, the wide qkv ``[..., 8f]`` through the
    grouped-column store. CPU tensors take :func:`lin_d8_sync_reference`; CUDA
    tensors launch the core. The op runs on no model path."""
    if not on_cuda(tuple(xs) + (w1, we, bias)):
        return lin_d8_sync_reference(xs, w1, we, bias, gelu, layerscale, residual, num_heads)
    xs = tuple(xs)
    _, c, f = w1.shape
    lead, ldx, ldxe = _row_strides(xs, c, "xs")
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    check_kernel_arg(bias, "bias", (f,))
    if (num_heads is not None and (gelu or layerscale is not None)) or (
            gelu and layerscale is not None):
        raise ValueError("lin_d8_sync: one epilogue at most, and none with the wide store")
    ls1 = lse = None
    rs = (None,) * 5
    if layerscale is not None:
        ls1, lse = layerscale
        check_kernel_arg(ls1, "ls1", (4, f))
        check_kernel_arg(lse, "lse", (2 * f,))
        rs = tuple(residual)
        if _check_tuple(rs, f) != lead:
            raise ValueError("lin_d8_sync: the residual must have the output's shape")
    kw = dict(device=xs[0].device, dtype=xs[0].dtype)
    if num_heads is not None:
        d1, de = _wide_dims(f, num_heads)
        out = torch.empty(*lead, 8 * f, **kw)
        ys, yes = tuple(out[..., g * d1:] for g in range(4)), (out[..., 4 * d1:],
                                                             out[..., 4 * d1 + de:])
        lds, groups = (8 * f, 8 * f), (d1, 8 * d1, de, 8 * d1)
    else:
        out = tuple(torch.empty(*lead, f, **kw) for _ in range(4)) + (
            torch.empty(*lead, 4 * f, **kw),)
        ys, yes = out[:4], (out[4], out[4][..., 2 * f:])
        lds, groups = (f, 4 * f), (f, 0, 2 * f, 0)
    lin_d8_sync.launches += 1
    kernels.launch("ovt_lin_d8_sync", *xs, w1, we, bias, *ys, *yes, ls1, lse, *rs,
                   xs[0].numel() // c, c, f, int(gelu), ldx, ldxe, *lds, *groups)
    return out


lin_d8_sync.launches = 0
lin_d8_sync.reference = lin_d8_sync_reference
