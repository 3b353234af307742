"""Plain float32 DeiT III train step (TF32 off), written from the recipe: the
per-step generator's draws (Mixup or CutMix with the reversed batch, then
each block's two drop-path masks), the forward of
:mod:`benchmark.reference.octic_vit`, binary cross entropy against the
mixed targets clamped to [0, 1], the clip of the global gradient norm, LAMB
over two parameter groups (decayed: every tensor of rank 2 or more outside
the positional embedding and the cls token) and the warmup-cosine learning
rate, and the model's EMA after each update, kept in float64.

The recipe's randomness is drawn here again from the seed the benchmark
hands both sides, with the algorithms the recipe names (timm's Mixup and
CutMix in batch mode, gamma draws by Marsaglia and Tsang, uniforms per
sample for drop path), in the recipe's order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import octic_vit
from benchmark.reference.leaves import leaf_norms


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's CPU generator (the recipe's loop seeds a fresh
    generator per step from the run's seed and the step number)."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def _gamma(alpha: float, gen: torch.Generator) -> float:
    boost = 1.0
    if alpha < 1.0:
        boost = torch.rand((), generator=gen).item() ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=gen).item()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = torch.rand((), generator=gen).item()
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(a: float, gen: torch.Generator) -> float:
    x, y = _gamma(a, gen), _gamma(a, gen)
    return x / (x + y)


def mix(images: torch.Tensor, labels: torch.Tensor, classes: int, gen: torch.Generator,
        mixup_alpha: float, cutmix_alpha: float, prob: float, switch_prob: float) -> tuple:
    """(mixed images, soft targets): each image with its partner in the
    reversed batch, by Mixup or by a CutMix box whose area corrects lambda."""
    _, h, w, _ = images.shape
    u = torch.rand(2, generator=gen)
    apply, use_cut = bool(u[0] < prob), bool(u[1] < switch_prob)
    lam_mix = _beta(mixup_alpha, gen) if mixup_alpha > 0 else 1.0
    lam_cut = _beta(cutmix_alpha, gen) if cutmix_alpha > 0 else 1.0
    cy = int(torch.randint(0, h, (), generator=gen))
    cx = int(torch.randint(0, w, (), generator=gen))
    y1 = F.one_hot(labels.long(), classes).float()
    if not apply:
        return images, y1
    y2, other = y1.flip(0), images.flip(0)
    if use_cut:
        ratio = np.sqrt(np.float32(1.0) - np.float32(lam_cut))
        ch, cw = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
        yl, yh = min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h)
        xl, xh = min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w)
        out = images.clone()
        out[:, yl:yh, xl:xh] = other[:, yl:yh, xl:xh]
        lam = 1.0 - float(np.float32((yh - yl) * (xh - xl)) / np.float32(h * w))
    else:
        out = images * lam_mix + other * (1.0 - lam_mix)
        lam = lam_mix
    return out, y1 * lam + y2 * (1.0 - lam)


def drop_masks(gen: torch.Generator, depth: int, batch: int, rate: float, device) -> list:
    """Each block's two per-sample scales ``[B, 1, 1]``: 1/keep with
    probability keep, else 0."""
    keep = 1.0 - rate
    out = []
    for _ in range(depth):
        pair = []
        for _ in range(2):
            u = torch.rand((batch,), generator=gen)
            pair.append(((u < keep).float() / keep).to(device).reshape(batch, 1, 1))
        out.append(tuple(pair))
    return out


def lr_at(step: int, t: dict) -> float:
    warmup = t["warmup_epochs"] * t["steps_per_epoch"]
    total = t["epochs"] * t["steps_per_epoch"]
    if step < warmup:
        return t["warmup_lr"] + (t["lr"] - t["warmup_lr"]) * step / max(warmup, 1)
    x = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return t["min_lr"] + 0.5 * (t["lr"] - t["min_lr"]) * (1 + math.cos(math.pi * x))


def decayed(name: str, shape) -> bool:
    return len(shape) > 1 and "pos_embed" not in name and "cls_token" not in name


def run(p0: Dict[str, torch.Tensor], model_cfg: dict, train: dict, batches: List[tuple],
        seed: int, forward: Callable = octic_vit.forward, q: Callable = octic_vit.ident,
        chunk: int = 16, half_batch: bool = False) -> dict:
    """Three (or ``len(batches)``) steps from the weights `p0` on the
    (images, labels) `batches` through the model reference `forward`. Returns
    each step's loss, each leaf's gradient norm as the optimizer got it at the
    first step, each leaf's change after the last step and its EMA's change
    (the recipe's ``ema_decay``, float64). `half_batch` leaves out the
    second half of each batch (a planted fault)."""
    names = list(p0)
    p = {n: t.detach().clone().requires_grad_(True) for n, t in p0.items()}
    m = {n: torch.zeros_like(t) for n, t in p0.items()}
    v = {n: torch.zeros_like(t) for n, t in p0.items()}
    ema = {n: t.detach().double() for n, t in p0.items()}
    decay = train["ema_decay"]
    b1, b2 = train["betas"]
    losses, first_grad = [], None
    for i, (images, labels) in enumerate(batches):
        step = train["start_step"] + i
        gen = torch.Generator().manual_seed(step_seed(seed, step))
        x, y = mix(images.float(), labels, model_cfg["num_classes"], gen, train["mixup_alpha"],
                   train["cutmix_alpha"], train["mixup_prob"], train["mixup_switch_prob"])
        y = y.clamp(0.0, 1.0)
        bsz = x.shape[0]
        masks = drop_masks(gen, model_cfg["depth"], bsz, train["drop_path"], x.device)
        rows = bsz // 2 if half_batch else bsz
        total = 0.0
        for s in range(0, rows, chunk):
            e = min(s + chunk, rows)
            mk = [(a[s:e], c[s:e]) for a, c in masks]
            logits = forward(p, model_cfg, x[s:e], q, mk)
            part = F.binary_cross_entropy_with_logits(logits, y[s:e]) * ((e - s) / rows)
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [p[n].grad for n in names]
            gnorm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            scale = torch.clamp(train["clip_grad"] / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
            if first_grad is None:
                first_grad = leaf_norms((n, p[n].grad) for n in names)
            lr = lr_at(step, train)
            k = i + 1
            for n in names:
                g, w = p[n].grad, p[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[n] / (1 - b1 ** k)) / ((v[n] / (1 - b2 ** k)).sqrt() + train["eps"])
                if decayed(n, w.shape):
                    u = u + train["weight_decay"] * w
                pn, un = w.norm(), u.norm()
                trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                w.add_(u * (-lr * trust))
                w.grad = None
                ema[n].mul_(decay).add_(w.double(), alpha=1 - decay)
    with torch.no_grad():
        change = leaf_norms((n, p[n] - p0[n]) for n in names)
        ema_change = leaf_norms((n, ema[n] - p0[n].double()) for n in names)
    return {"losses": losses, "grad": first_grad, "change": change, "ema_change": ema_change}
