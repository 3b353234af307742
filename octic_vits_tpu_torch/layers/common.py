"""Helpers that the octic and the standard layers and models share: the cast
of parameters to the compute dtype, per-block remat, and drop-path masks
drawn before the forward."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A parameter in the compute dtype (flax casts ``param_dtype``
    parameters to ``dtype`` at use); ``None`` stays ``None``."""
    return None if p is None else p.to(dtype)


def remat(fn, *args):
    """Per-block rematerialization (models/scan_blocks.py's ``remat``): run
    `fn` without keeping its intermediates and recompute them in the
    backward. The callers keep the attention kernels outside `fn`, so the
    values that cross between two remat regions (the attention kernel's
    inputs and outputs, the flax ``attn_in`` / ``attn_out`` names) are the
    ones saved, and the backward replay never re-runs an attention kernel.
    Random masks are drawn before the forward and passed in as arguments, so
    the replay needs no RNG state."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def drop_path_mask(batch: int, rate: float, generator: torch.Generator, *,
                   device=None, dtype=None) -> torch.Tensor:
    """Per-sample stochastic-depth mask ``[B, 1, 1]``: 1/keep with
    probability keep = 1 - rate, else 0, drawn from `generator`."""
    keep = 1.0 - rate
    u = torch.rand(batch, generator=generator, device=generator.device)
    mask = (u < keep).to(device=device, dtype=torch.float32)
    if keep > 0.0:
        mask = mask / keep
    return mask.to(dtype).reshape(batch, 1, 1)


class DropPathMask(nn.Module):
    """The drop-path rate of one residual branch and the draw of its mask.
    The mask is drawn by :meth:`draw` before the forward (from an explicit
    generator) and handed to the block, so a rematerialized block replays
    the same mask. Subclasses apply it to their branch in ``forward``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, batch: int, generator: Optional[torch.Generator], *, device=None,
             dtype=None) -> Optional[torch.Tensor]:
        if self.rate == 0.0 or not self.training:
            return None
        if generator is None:
            raise ValueError("drop path in training needs a torch.Generator")
        return drop_path_mask(batch, self.rate, generator, device=device, dtype=dtype)


def draw_block_masks(blocks, batch: int, generator: Optional[torch.Generator], *, device,
                     dtype) -> list:
    """Every block's two drop-path masks, drawn in block order before the
    trunk runs (so remat replays them): ``(None, None)`` where drop path is
    off or the model is in eval mode."""
    return [blk.draw_masks(batch, generator, device=device, dtype=dtype) for blk in blocks]
