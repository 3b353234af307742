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


def row_stride(t: torch.Tensor, name: str, shape: tuple, align: bool = False) -> int:
    """A bf16 ``[..., W]`` of exactly `shape` whose channels have unit stride
    and whose token rows (every index of the leading dims, in order) are
    evenly spaced: a contiguous tensor, or a column slice of one (the E rows
    of a flat-E qkv, the slot views of a packed container). Returns the row
    stride in elements, for a kernel that takes one per segment. With
    `align`, the view's start and its row stride must also be multiples of
    16 bytes, as the kernels' 16-byte copies (``cp.async``) need."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    lead, w = tuple(shape[:-1]), shape[-1]
    # the stride of the innermost leading dim that has more than one index
    ld = next((t.stride(i) for i in reversed(range(len(lead))) if lead[i] > 1), w)
    span = ld
    ok = t.stride(-1) == 1
    for i in reversed(range(len(lead))):
        ok &= lead[i] == 1 or t.stride(i) == span
        span *= lead[i]
    if not ok or ld < w:
        raise ValueError(f"{name}: needs unit channel stride and evenly spaced token rows, "
                         f"got strides {t.stride()}")
    if align and (t.data_ptr() % 16 or ld % 8):
        raise ValueError(f"{name}: the view's start and its row stride ({ld} elements) must "
                         "be multiples of 16 bytes")
    return ld
