"""gelu(x @ W^T + b): the standard MLP's fc1 with the exact-erf GELU applied
before the single store (counterpart of octic_vits_tpu/ops/pallas_dense.py:
dense_gelu). The weight is in torch Linear layout ``[F, C]``."""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_exact


def dense_gelu_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version: f32 math, exact erf, result in ``x.dtype``."""
    y = torch.matmul(x.float(), weight.float().t())
    if bias is not None:
        y = y + bias.float()
    return gelu_exact(y).to(x.dtype)


def dense_gelu(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., C]``, ``weight [F, C]``, ``bias [F]`` -> ``[..., F]``.

    CPU tensors take :func:`dense_gelu_reference`; CUDA tensors launch the
    K-dense kernel (csrc/dense.cu): bf16, contiguous, C and F multiples of 8."""
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
    y = torch.empty(*x.shape[:-1], f, device=x.device, dtype=x.dtype)
    dense_gelu.launches += 1
    kernels.launch("ovt_dense_gelu", x, weight, bias, y, m, f, c)
    return y


dense_gelu.launches = 0
