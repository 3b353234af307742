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
