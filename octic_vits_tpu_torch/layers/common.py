"""Helpers that the octic and the standard layers and models share: the cast
of parameters to the compute dtype, per-block remat, and the drop-path and
dropout masks drawn before the forward."""

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


def dropout_mask(shape: tuple, generator: Optional[torch.Generator], *,
                 device=None) -> torch.Tensor:
    """A dropout mask of `shape` drawn from `generator`: the uniforms of the
    draw, kept as they are so that :func:`dropout` compares them with its
    keep probability (flax ``nn.Dropout`` keeps an element with probability
    1 - rate)."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def dropout(x: torch.Tensor, u: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with the uniforms `u` of :func:`dropout_mask`:
    ``x / keep`` where ``u < keep``, else 0; ``None`` is the identity."""
    if u is None:
        return x
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(x)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax ``nn.Dropout`` with masks drawn before the forward: :meth:`draw`
    draws the uniforms of one mask (``None`` unless the module is training
    with a rate above 0) and ``forward(x, u)`` applies them; a tuple `x` takes
    a tuple of masks, one an element (DropoutD8). Training with a rate above 0
    and no mask raises: a missing mask must not turn dropout off."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def active(self) -> bool:
        return self.rate > 0.0 and self.training

    def draw(self, shapes, generator: Optional[torch.Generator], *, device=None):
        """One mask of shape `shapes`, or a tuple of masks for a tuple of shapes."""
        if not self.active():
            return None
        if isinstance(shapes[0], (tuple, list)):
            return tuple(dropout_mask(s, generator, device=device) for s in shapes)
        return dropout_mask(shapes, generator, device=device)

    def forward(self, x, u=None):
        if not self.active():
            return x
        if u is None:
            raise ValueError("dropout in training needs the masks of draw_masks")
        if isinstance(x, torch.Tensor):
            return dropout(x, u, self.rate)
        return tuple(dropout(t, m, self.rate) for t, m in zip(x, u))


def draw_block_masks(blocks, batch: int, generator: Optional[torch.Generator], *, device,
                     dtype, tokens: int = 0) -> list:
    """Every block's masks, drawn in block order before the trunk runs (so
    remat replays them): its two drop-path masks, ``None`` where drop path
    is off or the model is in eval mode, and, where dropout is on in
    training, its dropout masks at `tokens` tokens (``Block.draw_masks``)."""
    return [blk.draw_masks(batch, generator, device=device, dtype=dtype, tokens=tokens)
            for blk in blocks]
