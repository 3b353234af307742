"""Mixup / CutMix on the device (timm Mixup semantics, batch mode;
counterpart of octic_vits_tpu/data/mixup.py).

The random draws of one batch (:func:`draw_mixup`, from an explicit
``torch.Generator``) are kept apart from the mixing (:func:`mixup_cutmix`),
so that a test can hand the port and the JAX function the same draws. Each
sample is paired with its partner in the reversed batch; CutMix's ``lam`` is
corrected to the realized box area, as timm does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """f32 one-hot targets ``[B, K]`` with label smoothing (mixup.py:one_hot_smooth)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    hot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return hot * (on - off) + off


@dataclasses.dataclass(frozen=True)
class MixDraws:
    """The random draws of one batch: whether to mix at all, CutMix or Mixup,
    the two Beta draws, and the CutMix box centre (row, column)."""

    apply: bool
    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


def _gamma(alpha: float, generator: torch.Generator) -> float:
    """One Gamma(alpha, 1) draw (Marsaglia and Tsang), from `generator`."""
    boost = 1.0
    if alpha < 1.0:
        boost = torch.rand((), generator=generator).item() ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=generator).item()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = torch.rand((), generator=generator).item()
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(a: float, generator: torch.Generator) -> float:
    x, y = _gamma(a, generator), _gamma(a, generator)
    return x / (x + y)


def draw_mixup(generator: torch.Generator, h: int, w: int, mixup_alpha: float = 0.8,
               cutmix_alpha: float = 1.0, prob: float = 1.0,
               switch_prob: float = 0.5) -> MixDraws:
    """The draws of mixup.py:mixup_cutmix (and its ``_rand_bbox``) for one
    batch of ``h x w`` images, taken from a CPU `generator`."""
    u = torch.rand(2, generator=generator)
    return MixDraws(
        apply=bool(u[0] < prob),
        use_cutmix=bool(u[1] < switch_prob),
        lam_mix=_beta(mixup_alpha, generator) if mixup_alpha > 0 else 1.0,
        lam_cut=_beta(cutmix_alpha, generator) if cutmix_alpha > 0 else 1.0,
        cy=int(torch.randint(0, h, (), generator=generator)),
        cx=int(torch.randint(0, w, (), generator=generator)),
    )


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int) -> tuple:
    """(yl, yh, xl, xh): a sqrt(1 - lam) fraction of each side around
    (cy, cx), clipped to the image (mixup.py:_rand_bbox, in f32 as there)."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    clip = lambda v, hi: min(max(v, 0), hi)  # noqa: E731
    return (clip(cy - cut_h // 2, h), clip(cy + cut_h // 2, h),
            clip(cx - cut_w // 2, w), clip(cx + cut_w // 2, w))


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, num_classes: int, draws: MixDraws,
                 label_smoothing: float = 0.0) -> tuple:
    """images ``[B, H, W, C]``, int labels ``[B]`` -> (mixed images, f32 soft
    targets ``[B, K]``), with the given draws."""
    _, h, w, _ = images.shape
    y1 = one_hot_smooth(labels, num_classes, label_smoothing)
    y2 = y1.flip(0)
    if not draws.apply:
        return images, y1
    flipped = images.flip(0)
    if draws.use_cutmix:
        yl, yh, xl, xh = cutmix_box(h, w, draws.lam_cut, draws.cy, draws.cx)
        mixed = images.clone()
        mixed[:, yl:yh, xl:xh] = flipped[:, yl:yh, xl:xh]
        lam = 1.0 - float(np.float32((yh - yl) * (xh - xl)) / np.float32(h * w))
    else:
        lam_m = torch.tensor(draws.lam_mix, dtype=images.dtype, device=images.device)
        mixed = images * lam_m + flipped * (1.0 - lam_m)
        lam = draws.lam_mix
    lam_t = torch.tensor(lam, dtype=torch.float32, device=y1.device)
    return mixed, y1 * lam_t + y2 * (1.0 - lam_t)
