"""Shared argument checks for the kernel wrappers in this package.

A wrapper runs its plain version for CPU tensors and its CUDA kernel for
CUDA tensors; anything else, or an argument the kernel does not take,
raises."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def on_cuda(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """True when every given tensor is on the current CUDA device, False
    when every one is on the CPU; raises on a mix or another device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {dev}, current device is cuda:{torch.cuda.current_device()}")
    return True


def check_kernel_arg(t: Optional[torch.Tensor], name: str, shape: tuple) -> None:
    """bf16, contiguous, 16-byte aligned, of exactly `shape`."""
    if t is None:
        return
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def row_stride(t: torch.Tensor, name: str, shape: tuple) -> int:
    """A bf16 ``[B, N, W]`` of exactly `shape` whose channels have unit stride
    and whose token rows are evenly spaced: a contiguous tensor, or a column
    slice of one (the E rows of a flat-E qkv). Returns the token row stride
    in elements, for a kernel that takes one per segment."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    b, n, w = shape
    ld = t.stride(1) if n > 1 else (t.stride(0) if b > 1 else w)
    if t.stride(2) != 1 or ld < w or (b > 1 and t.stride(0) != n * ld):
        raise ValueError(f"{name}: needs unit channel stride and evenly spaced token rows, "
                         f"got strides {t.stride()}")
    return ld


def forward_only(name: str, tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """A fused inference kernel with no backward kernel (the fused octic MLP)
    refuses to run where autograd would record it: its output would carry
    no gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: inference kernel without a backward; train through "
                           "linear_d8_fused")
