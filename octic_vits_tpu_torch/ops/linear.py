"""Block-diagonal D8-equivariant linear maps on the flat-E 5-tuple, and the
octic MLP fc1 -> D8-GELU -> fc2 (counterpart of
octic_vits_tpu/ops/pallas_linear.py:mlp_d8_fused and the mlp_d8_tuple
wrapper, which here takes the five tensors directly).

Layouts: ``xs = (a1, a2, b1, b2, ef)`` with ``a* [..., c]`` and
``ef [..., 4c] = [row0 | row1]``; weights ``w1 [4, c, f]`` (one per 1-d
irrep), ``we [2c, 2f]`` (applied to each E row separately) and an A1-only
bias ``[f]``. Outputs have the same layout at width f.
"""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_d8_eager


def linear_d8(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
              bias: Optional[torch.Tensor]) -> tuple:
    """The LinearD8 map in the inputs' dtype with plain torch products (the
    octic attention's proj runs this; so do the plain versions, in f32)."""
    c = xs[0].shape[-1]
    outs = [torch.matmul(xs[g], w1[g]) for g in range(4)]
    if bias is not None:
        outs[0] = outs[0] + bias
    ef = xs[4]
    rows = torch.matmul(ef.reshape(*ef.shape[:-1], 2, 2 * c), we)
    return tuple(outs) + (rows.reshape(*ef.shape[:-1], 2 * we.shape[-1]),)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


def mlp_d8_fused_reference(xs: tuple, w1a, wea, b1, w1b, web, b2) -> tuple:
    """Plain version: f32 math and exact erf; the hidden is rounded to the
    input dtype between the GELU and fc2, where the kernel stores it."""
    dt = xs[0].dtype
    hid = linear_d8(tuple(x.float() for x in xs), w1a.float(), wea.float(), _f32(b1))
    hid = tuple(t.to(dt).float() for t in gelu_d8_eager(hid))
    out = linear_d8(hid, w1b.float(), web.float(), _f32(b2))
    return tuple(t.to(dt) for t in out)


def _check_tuple(xs: tuple, c: int) -> tuple:
    lead = tuple(xs[0].shape[:-1])
    for g in range(4):
        check_kernel_arg(xs[g], f"xs[{g}]", lead + (c,))
    check_kernel_arg(xs[4], "xs[4]", lead + (4 * c,))
    return lead


def lin_d8_launch(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                  bias: Optional[torch.Tensor], gelu: bool) -> tuple:
    """One launch of the K-lin-d8 kernel (csrc/lin_d8.cu) on CUDA bf16
    tensors, with or without the D8-GELU epilogue. Counts nothing: the
    public ops that use it count their own launches."""
    _, c, f = w1.shape
    if c % 8 or f % 8:
        raise ValueError(f"lin_d8: widths c={c}, f={f} must be multiples of 8")
    lead = _check_tuple(xs, c)
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    check_kernel_arg(bias, "bias", (f,))
    m = xs[0].numel() // c
    kw = dict(device=xs[0].device, dtype=xs[0].dtype)
    ys = tuple(torch.empty(*lead, f, **kw) for _ in range(4))
    yef = torch.empty(*lead, 4 * f, **kw)
    kernels.launch("ovt_lin_d8", *xs, w1, we, bias, *ys, yef, m, c, f, int(gelu))
    return ys + (yef,)


def mlp_d8_fused(xs: tuple, w1a, wea, b1, w1b, web, b2) -> tuple:
    """Octic MLP: fc1 (c -> h) with the D8-GELU epilogue, fc2 (h -> c').

    CPU tensors take :func:`mlp_d8_fused_reference`; CUDA tensors launch
    K-lin-d8 twice (fc1 writes the bf16 hidden, fc2 reads it)."""
    if not on_cuda(tuple(xs) + (w1a, wea, b1, w1b, web, b2)):
        return mlp_d8_fused_reference(xs, w1a, wea, b1, w1b, web, b2)
    if w1b.shape[1] != w1a.shape[2]:
        raise ValueError("mlp_d8_fused: fc2 input width must equal fc1 output width")
    mlp_d8_fused.launches += 1
    hid = lin_d8_launch(xs, w1a, wea, b1, gelu=True)
    return lin_d8_launch(hid, w1b, web, b2, gelu=False)


mlp_d8_fused.launches = 0
