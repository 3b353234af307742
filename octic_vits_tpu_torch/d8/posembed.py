"""Equivariant positional-embedding utilities (torch counterpart of
octic_vits_tpu/d8/posembed.py): the quadrant unfold and the bicubic
(a = -0.75, half-pixel, edge-clamped) grid resize."""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _rot90(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    return torch.rot90(x, k=k, dims=(dim, dim + 1))


def unfold_quadrant(xs: Sequence[torch.Tensor], dim: int = 0) -> tuple:
    """Expand 6 quadrant tensors ``[..., H/2, W/2, C]`` (A1, A2, B1, B2,
    E-left, E-right; spatial axes at ``(dim, dim+1)``) into the full-grid
    isotypic 8-tuple ``[..., H, W, C]``."""
    d = dim

    def four_fold(x, rot_sign):
        top = torch.cat((x, rot_sign * _rot90(x, 1, d)), dim=d)
        bot = torch.cat((rot_sign * _rot90(x, 3, d), _rot90(x, 2, d)), dim=d)
        return torch.cat((top, bot), dim=d + 1)

    a1 = four_fold(xs[0], 1.0)
    a1 = a1 + torch.flip(a1, (d + 1,))
    a2 = four_fold(xs[1], 1.0)
    a2 = a2 - torch.flip(a2, (d + 1,))
    b1 = four_fold(xs[2], -1.0)
    b1 = b1 + torch.flip(b1, (d + 1,))
    b2 = four_fold(xs[3], -1.0)
    b2 = b2 - torch.flip(b2, (d + 1,))

    def e_fold(x):
        col = torch.cat((x, torch.flip(x, (d,))), dim=d)
        return torch.cat((col, -torch.flip(col, (d + 1,))), dim=d + 1)

    e_left = e_fold(xs[4])
    e_right = e_fold(xs[5])
    return (
        a1, a2, b1, b2,
        e_left, _rot90(e_left, 1, d),
        e_right, _rot90(e_right, 1, d),
    )


@functools.lru_cache(maxsize=64)
def _cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] bicubic (a=-0.75) interpolation matrix."""
    a = -0.75

    def kernel(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        if x < 2.0:
            return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
        return 0.0

    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        coord = (i + 0.5) * scale - 0.5
        base = int(np.floor(coord))
        t = coord - base
        for tap in range(-1, 3):
            src = min(max(base + tap, 0), in_size - 1)
            mat[i, src] += kernel(tap - t)
    return mat.astype(np.float32)


def resize_grid(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Bicubic resize of ``[..., H, W, C]`` to ``[..., h0, w0, C]``."""
    h0, w0 = out_hw
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (h0, w0):
        return x
    xf = x.float()
    wh = torch.from_numpy(_cubic_resize_matrix(h, h0)).to(x.device)
    ww = torch.from_numpy(_cubic_resize_matrix(w, w0)).to(x.device)
    out = torch.einsum("oh,...hwc->...owc", wh, xf)
    out = torch.einsum("ow,...hwc->...hoc", ww, out)
    return out.to(x.dtype)


def resize_posembed(pos: Sequence[torch.Tensor], grid_hw: tuple) -> tuple:
    """Resize each full-grid pos-embed tensor ``[H, W, C]`` to ``grid_hw``."""
    return tuple(resize_grid(p, grid_hw) for p in pos)
