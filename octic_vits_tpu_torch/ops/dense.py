"""gelu(x @ W^T + b): the standard MLP's fc1 with the exact-erf GELU applied
before the single store (counterpart of octic_vits_tpu/ops/pallas_dense.py:
dense_gelu). The weight is in torch Linear layout ``[F, C]``. Its backward
is plain torch, as the JAX one is the eager composite's VJP."""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_exact, gelu_grad

# The kernel's tiling (csrc/dense.cu): 128 x 128 output tiles, K blocks of
# 64, a ring of 6 stages of one x and one W box each, two consumer
# warpgroups, raster groups of DENSE_GROUP_M M-tiles.
DENSE_BM, DENSE_BN, DENSE_BK, DENSE_STAGES, DENSE_CONSUMERS = 128, 128, 64, 6, 2
DENSE_GROUP_M = 8
H100_SMS = 132


def dense_plan(m: int, f: int, k: int, sms: int = H100_SMS) -> dict:
    """The launch plan of K-dense for ``x [m, k] @ W[f, k]^T``: one
    persistent CTA an SM (never more CTAs than tiles), the raster's group
    size and the shared-memory bytes, which the C entry point checks against
    the kernel's own (align slack, the ring, 2 barriers a stage and 2 ordering
    barriers)."""
    m_tiles, f_tiles = -(-m // DENSE_BM), -(-f // DENSE_BN)
    stage = (DENSE_BM + DENSE_BN) * DENSE_BK * 2
    return {"grid": min(m_tiles * f_tiles, sms), "group_m": DENSE_GROUP_M,
            "smem": 1024 + DENSE_STAGES * stage + (2 * DENSE_STAGES + 2) * 8,
            "m_tiles": m_tiles, "f_tiles": f_tiles, "k_blocks": -(-k // DENSE_BK)}


def dense_tile(t: int, plan: dict) -> tuple:
    """Tile ``t`` of the raster -> (M-tile, F-tile), as csrc/dense.cu:
    tile_coords: groups of ``group_m`` M-tiles, each walked down M first."""
    g, mt, ft = plan["group_m"], plan["m_tiles"], plan["f_tiles"]
    gi, r = divmod(t, g * ft)
    first = gi * g
    size = min(g, mt - first)
    return first + r % size, r // size


def dense_tile_order(plan: dict) -> list:
    """Every (CTA, consumer warpgroup, M-tile, F-tile) the kernel computes, in
    each CTA's order: CTA c takes tiles c, c + grid, ...; its warpgroups take
    them in turns."""
    grid, total = plan["grid"], plan["m_tiles"] * plan["f_tiles"]
    return [(c, i % DENSE_CONSUMERS, *dense_tile(t, plan))
            for c in range(grid) for i, t in enumerate(range(c, total, grid))]


def dense_gelu_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version: f32 math, exact erf, result in ``x.dtype``."""
    y = torch.matmul(x.float(), weight.float().t())
    if bias is not None:
        y = y + bias.float()
    return gelu_exact(y).to(x.dtype)


def _dense_gelu_fwd(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    if not on_cuda((x, weight, bias)):
        return dense_gelu_reference(x, weight, bias)
    f, c = weight.shape
    if x.shape[-1] != c or c % 8 or f % 8:
        raise ValueError(f"dense_gelu: x {tuple(x.shape)} vs weight {tuple(weight.shape)}; "
                         "C and F must be multiples of 8")
    m = x.numel() // c
    check_kernel_arg(x, "x", tuple(x.shape))
    check_kernel_arg(weight, "weight", (f, c))
    check_kernel_arg(bias, "bias", (f,))
    plan = dense_plan(m, f, c, torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty(*x.shape[:-1], f, device=x.device, dtype=x.dtype)
    dense_gelu.launches += 1
    kernels.launch("ovt_dense_gelu", x, weight, bias, y, m, f, c, plan["grid"], plan["group_m"],
                   plan["smem"])
    return y


def dense_gelu_bwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   g: torch.Tensor) -> tuple:
    """(dx, dweight, dbias) of gelu(x W^T + b), in plain torch as the JAX
    backward is the eager composite's VJP. Every product, the recompute of
    the pre-activation included, runs in the operands' dtype: bf16 with f32
    accumulation on the card (what XLA's default precision does with the JAX
    f32-cast products on the TPU, except that cuBLAS rounds the recomputed
    pre-activation to bf16), f32 on the CPU. The elementwise math is f32."""
    f, c = weight.shape
    dt = x.dtype
    wd = weight.to(dt)
    u = torch.matmul(x, wd.t()).float()
    if bias is not None:
        u = u + bias.float()
    du = g.float() * gelu_grad(u)
    dbias = None if bias is None else du.reshape(-1, f).sum(0).to(bias.dtype)
    dud = du.to(dt)
    dx = torch.matmul(dud, wd)
    dw = torch.matmul(dud.reshape(-1, f).t(), x.reshape(-1, c))
    return dx, dw.to(weight.dtype), dbias


class _DenseGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _dense_gelu_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        return dense_gelu_bwd(*ctx.saved_tensors, g)


def dense_gelu(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., C]``, ``weight [F, C]``, ``bias [F]`` -> ``[..., F]``.

    CPU tensors take :func:`dense_gelu_reference`; CUDA tensors launch the
    K-dense kernel (csrc/dense.cu, TMA + wgmma, :func:`dense_plan`): bf16,
    contiguous, C and F multiples of 8.
    The backward (:func:`dense_gelu_bwd`) saves x and the weights only."""
    return _DenseGelu.apply(x, weight, bias)


dense_gelu.launches = 0
