"""capi-style classification probes on frozen features (counterpart of
octic_vits_tpu/eval/attnpool.py; reference:
dinov2/eval/segmentation/eval_classification.py:195-545).

* representations: "cls" [B,D] and "avg_patch" [B,D] -> LinearClassifier;
  "patch" [B,N,D] -> AttnPoolClassifier (query-token parameter, KV-only
  projection, D//64 heads, no out-proj/LayerNorm — :200-231).
* the full hparam grid (10 learning rates x 3 weight decays, :326-327)
  trained jointly as one bank per representation: every parameter carries a
  leading member axis and the members run as batched products, with an
  AdamW written out per member (lr and wd vectors over the members).
* base_lr scaling lr * batch/256 (:412), AdamW betas (0.9, 0.95) (:428),
  cosine schedule with linear warmup (:497-501), best-on-val selection.

Initialisation as flax's ``truncated_normal(0.02)`` (N(0, 0.02^2) cut at
+-2 sigma) with zero biases, drawn from a ``torch.Generator`` seeded with
`seed` on the features' device; the numbers differ from JAX's.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from octic_vits_tpu_torch.eval.metrics import as_tensor
from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_

# reference grid (eval_classification.py:326-327)
LEARNING_RATES = (1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 1e-2)
WEIGHT_DECAYS = (5e-4, 1e-3, 5e-2)


class LinearClassifier(nn.Module):
    """`n_members` linear classifiers: ``weight [M, D, K]`` (flax's ``[in,
    out]`` kernel layout), ``bias [M, K]``; ``[B, D] -> [M, B, K]``."""

    def __init__(self, dim: int, num_classes: int, n_members: int = 1, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty(n_members, dim, num_classes, **kw))
        self.bias = nn.Parameter(torch.empty(n_members, num_classes, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        nn.init.zeros_(self.bias)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        f = feats.to(self.weight.dtype)
        return torch.einsum("bd,mdk->mbk", f, self.weight) + self.bias[:, None, :]


class AttnPoolClassifier(nn.Module):
    """`n_members` reference AttnPoolClassifiers (eval_classification.py:200-231):
    a trainable query token attends over the patch tokens through a KV-only
    projection with D//64 heads (one head for D < 64 or D not a multiple of
    64); a linear classifier on the pooled vector. ``[B, N, D] -> [M, B, K]``."""

    def __init__(self, dim: int, num_classes: int, n_members: int = 1, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.heads = dim // 64 if dim % 64 == 0 and dim >= 64 else 1
        self.query_token = nn.Parameter(torch.empty(n_members, dim, **kw))
        self.kv_weight = nn.Parameter(torch.empty(n_members, dim, 2 * dim, **kw))
        self.kv_bias = nn.Parameter(torch.empty(n_members, 2 * dim, **kw))
        self.weight = nn.Parameter(torch.empty(n_members, dim, num_classes, **kw))
        self.bias = nn.Parameter(torch.empty(n_members, num_classes, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.query_token, self.kv_weight, self.weight):
            trunc_normal_(p, 0.02, generator)
        nn.init.zeros_(self.kv_bias)
        nn.init.zeros_(self.bias)

    def forward(self, patch_tokens: torch.Tensor) -> torch.Tensor:
        x = patch_tokens.to(self.weight.dtype)
        b, n, d = x.shape
        m, h = self.query_token.shape[0], self.heads
        dh = d // h
        # every member's kv in one product: [B*N, D] @ [D, M*2D]
        w = self.kv_weight.permute(1, 0, 2).reshape(d, m * 2 * d)
        kv = (x.reshape(b * n, d) @ w).view(b, n, m, 2 * d) + self.kv_bias
        kv = kv.view(b, n, m, 2, h, dh)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]                    # [B, N, M, H, dh]
        q = self.query_token.view(m, h, dh)
        probs = torch.softmax(torch.einsum("mhd,bnmhd->mbhn", q, k) / math.sqrt(dh), dim=-1)
        pooled = torch.einsum("mbhn,bnmhd->mbhd", probs, v).reshape(m, b, d)
        return torch.einsum("mbd,mdk->mbk", pooled, self.weight) + self.bias[:, None, :]


def _cosine_warmup(it: int, n_iters: int, warmup: int) -> float:
    warm = min(1.0, (it + 1) / max(warmup, 1))
    prog = min(max((it - warmup) / max(n_iters - warmup, 1), 0.0), 1.0)
    return warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def _per_member_loss(module: nn.Module, feats: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Each member's mean cross-entropy over the batch, ``[M]``."""
    logp = torch.log_softmax(module(feats), dim=-1)               # [M, B, K]
    idx = labels.view(1, -1, 1).expand(logp.shape[0], -1, 1)
    return -logp.gather(-1, idx).squeeze(-1).mean(dim=-1)


@torch.no_grad()
def _adamw(params, grads, mu, nu, it: int, sched: float, base_lrs: torch.Tensor,
           wds: torch.Tensor, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8) -> None:
    """The inline AdamW of the JAX grid (attnpool.py:134-152) on every leaf,
    one lr and wd per member: ``p -= lr s(it) (m_hat / (sqrt(v_hat) + eps) +
    wd p)``."""
    t = it + 1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, m, v in zip(params, grads, mu, nu):
        shape = (-1,) + (1,) * (p.dim() - 1)
        lr = (sched * base_lrs).view(shape)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p -= lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + wds.view(shape) * p)


def bank_step(module: nn.Module, mu: list, nu: list, feats: torch.Tensor, labels: torch.Tensor,
              it: int, sched: float, base_lrs: torch.Tensor, wds: torch.Tensor) -> torch.Tensor:
    """One step of a bank: every member's mean cross-entropy, their sum's
    gradient (each member's own, the members being independent), and the
    AdamW update with the members' lrs and wds; returns the losses ``[M]``."""
    params = list(module.parameters())
    with torch.enable_grad():
        losses = _per_member_loss(module, feats, labels)
        grads = torch.autograd.grad(losses.sum(), params)
    _adamw(params, grads, mu, nu, it, sched, base_lrs, wds)
    return losses.detach()


def train_probe_grid(
    feature_fn,
    train_iter_factory,
    eval_iter,
    num_classes: int,
    representations: Sequence[str] = ("cls", "avg_patch", "patch"),
    learning_rates: Sequence[float] = LEARNING_RATES,
    weight_decays: Sequence[float] = WEIGHT_DECAYS,
    n_iters: int = 12_500,
    warmup_iters: int = 1_250,
    batch_size: int = 128,
    val_iter: Optional[Iterable] = None,
    seed: int = 0,
    init_banks: Optional[Mapping[str, Mapping[str, object]]] = None,
) -> Dict[str, float]:
    """feature_fn(images) -> {"cls": [B,D], "avg_patch": [B,D],
    "patch": [B,N,D]} (any subset matching `representations`).

    Trains, per representation, a bank of len(lrs)*len(wds) classifiers
    jointly (one frozen-backbone forward feeds every member), evaluates all
    members, and reports the best (eval_classification.py:407-530). A bank
    lives on its features' device. `init_banks` (representation -> {parameter
    name: ``[M, ...]`` array}) sets a bank's starting parameters in place of
    the seeded draw."""
    grid = list(itertools.product(learning_rates, weight_decays))
    n_members = len(grid)
    banks = {}   # rep -> (module, mu, nu, base lrs, wds)
    last_losses = {}
    it = 0
    src = iter(train_iter_factory())
    while it < n_iters:
        try:
            images, labels = next(src)
        except StopIteration:
            src = iter(train_iter_factory())
            continue
        feats_all = feature_fn(images)
        for rep in representations:
            feats = as_tensor(feats_all[rep])
            dev = feats.device
            if rep not in banks:
                cls = AttnPoolClassifier if feats.dim() == 3 else LinearClassifier
                module = cls(feats.shape[-1], num_classes, n_members, device=dev)
                if init_banks is not None and rep in init_banks:
                    with torch.no_grad():
                        for name, p in module.named_parameters():
                            p.copy_(torch.as_tensor(np.asarray(init_banks[rep][name])))
                else:
                    module.reset_parameters(torch.Generator(dev).manual_seed(seed))
                params = list(module.parameters())
                banks[rep] = (module, [torch.zeros_like(p) for p in params],
                              [torch.zeros_like(p) for p in params],
                              torch.tensor([lr * batch_size / 256.0 for lr, _ in grid], device=dev),
                              torch.tensor([wd for _, wd in grid], device=dev))
            module, mu, nu, base_lrs, wds = banks[rep]
            y = as_tensor(labels, dev).to(dev, torch.int64)
            losses = bank_step(module, mu, nu, feats, y, it,
                               _cosine_warmup(it, n_iters, warmup_iters), base_lrs, wds)
            last_losses[rep] = losses
        it += 1

    # evaluate every member on (val or eval) data; report the best per rep
    results: Dict[str, float] = {}
    eval_batches = list(val_iter if val_iter is not None else eval_iter)
    for rep, (module, *_) in banks.items():
        hits = np.zeros((n_members,), np.int64)
        total = 0
        for images, labels in eval_batches:
            feats = as_tensor(feature_fn(images)[rep])
            y = as_tensor(labels, feats.device).to(feats.device, torch.int64)
            with torch.no_grad():
                hits += (module(feats).argmax(-1) == y[None]).sum(-1).cpu().numpy()
            total += len(labels)
        accs = hits / max(total, 1)
        best = int(accs.argmax())
        lr, wd = grid[best]
        results[f"{rep}_top1"] = float(accs[best])
        results[f"{rep}_best_lr"] = lr
        results[f"{rep}_best_wd"] = wd
    if last_losses:
        results["final_loss"] = float(np.mean([v.mean().item() for v in last_losses.values()]))
    return results


def train_attnpool_probe(feature_fn, train_iter_factory, eval_iter, num_classes: int,
                         iters: int = 2000, lr: float = 1e-4, num_heads: int = 8,
                         seed: int = 0) -> Dict[str, float]:
    """Single attnpool probe on patch tokens (feature_fn -> [B, N, D])."""
    del num_heads  # kept for API compat; the probe uses D//64 heads
    res = train_probe_grid(
        lambda images: {"patch": feature_fn(images)},
        train_iter_factory,
        eval_iter,
        num_classes,
        representations=("patch",),
        learning_rates=(lr,),
        weight_decays=(1e-4,),
        n_iters=iters,
        warmup_iters=max(iters // 10, 1),
        seed=seed,
    )
    return {"attnpool_top1": res["patch_top1"], "final_loss": res.get("final_loss", 0.0)}
