"""DeiT III supervised training engine (counterpart of
octic_vits_tpu/train/deit/engine.py): one train step does mixup/cutmix, the
forward and backward (BCE on the mixed targets, or CE; optional cosub and
distillation; gradient accumulation), the global-norm clip, the LAMB or
AdamW update with the warmup-cosine schedule, and the EMA.

Randomness comes from one explicit ``torch.Generator`` per step: the mixup
draws first, then every forward's drop-path masks, in order.

On a state laid out over processes (``train.common.state_shardings``) each
process holds a contiguous block of the global batch and the step computes
what the one-process step computes on the global batch: every process draws
the same mixup draws, a row's mixup partner (row B - 1 - i of the global
batch) comes from the process at the mirror position, the drop-path masks
are drawn for the global batch and each process keeps its rows, and the
metrics are averaged over the processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from octic_vits_tpu_torch.data.mixup import draw_mixup, mixup_cutmix, one_hot_smooth
from octic_vits_tpu_torch.layers.common import global_batch_rows
from octic_vits_tpu_torch.parallel import sharding
from octic_vits_tpu_torch.parallel.mesh import batch_sharding, mirror_block, reduce_mean
from octic_vits_tpu_torch.train.common import TrainState, bce_target_loss, cross_entropy_loss
from octic_vits_tpu_torch.train.deit.losses import distillation_loss
from octic_vits_tpu_torch.train.optim import Lamb
from octic_vits_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DeiTConfig:
    """Paper hparams (the JAX ``DeiTConfig``, field for field)."""

    num_classes: int = 1000
    epochs: int = 400
    batch_size: int = 2048          # effective/global
    lr: float = 3e-3
    unscale_lr: bool = True         # lr is absolute (no batch/512 scaling)
    weight_decay: float = 0.02
    warmup_epochs: int = 5
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    loss_type: str = "bce"          # bce | ce | soft_ce
    smoothing: float = 0.0
    cosub: bool = False
    opt: str = "lamb"               # lamb | adamw
    opt_betas: Optional[tuple] = None
    model_ema: bool = True
    drop: float = 0.0
    repeated_aug: bool = True
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    drop_path: float = 0.45
    ema_decay: float = 0.99996
    clip_grad: Optional[float] = 1.0
    steps_per_epoch: int = 625
    opt_eps: float = 1e-8
    attn_only: bool = False
    distillation_type: str = "none"  # none | soft | hard
    distillation_alpha: float = 0.5
    distillation_tau: float = 1.0
    accum_steps: int = 1


def lr_schedule(cfg: DeiTConfig) -> Callable[[int], float]:
    """Cosine with linear warmup, per optimizer step (timm ``cosine``)."""
    warmup = cfg.warmup_epochs * cfg.steps_per_epoch
    total = cfg.epochs * cfg.steps_per_epoch
    base = cfg.lr if cfg.unscale_lr else cfg.lr * cfg.batch_size / 512.0

    def fn(step: int) -> float:
        if step < warmup:
            return cfg.warmup_lr + (base - cfg.warmup_lr) * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return cfg.min_lr + 0.5 * (base - cfg.min_lr) * (1 + math.cos(math.pi * t))

    return fn


def no_weight_decay_mask(model: nn.Module,
                         extra_names: tuple = ("pos_embed", "cls_token")) -> Dict[str, bool]:
    """timm rule, per parameter name: no decay for 1-d tensors and for the
    model's no-weight-decay names. (The JAX mask reads the rank of the
    scanned tree's stacked leaves, where a block's 1-d tensors gain the depth
    axis; the port decides per block tensor, as timm does.)"""
    return {n: not any(x in n for x in extra_names) and p.ndim > 1
            for n, p in model.named_parameters()}


def build_optimizer(cfg: DeiTConfig, model: nn.Module) -> torch.optim.Optimizer:
    """LAMB (the pretraining optimizer) or AdamW (the finetuning recipes'),
    with two parameter groups, decayed and not. The step sets the lr."""
    mask = no_weight_decay_mask(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    betas = tuple(cfg.opt_betas or (0.9, 0.999))
    lr0 = lr_schedule(cfg)(0)
    if cfg.opt == "adamw":
        return torch.optim.AdamW(groups, lr=lr0, betas=betas, eps=cfg.opt_eps)
    if cfg.opt != "lamb":
        raise ValueError(f"unknown optimizer {cfg.opt!r} (lamb|adamw)")
    return Lamb(groups, lr=lr0, betas=betas, eps=cfg.opt_eps)


def global_norm(tensors) -> torch.Tensor:
    """optax ``global_norm`` of whole tensors or DTensor shards."""
    return sharding.global_norm(tensors)


def make_deit_train_step(model: nn.Module, cfg: DeiTConfig, optimizer: torch.optim.Optimizer,
                         teacher_apply: Optional[Callable] = None,
                         trainable_mask: Optional[Dict[str, bool]] = None):
    """step(state, images, labels, generator) -> (state, metrics).

    `images` NHWC and int `labels` on the model's device; `generator` a CPU
    ``torch.Generator`` (mixup draws and drop-path masks). `teacher_apply`
    (images -> logits) enables distillation; `trainable_mask` (name ->
    bool) freezes the rest: frozen parameters get no gradient, so LAMB's
    moments and decoupled decay leave them alone. Metrics are 0-d tensors
    (``loss``, ``grad_norm``) so the step does not wait for the device."""
    if cfg.distillation_type != "none" and teacher_apply is None:
        raise ValueError(f"distillation_type={cfg.distillation_type!r} needs teacher_apply")
    schedule = lr_schedule(cfg)
    named = list(model.named_parameters())

    def loss_of(logits, targets):
        if cfg.loss_type == "bce":
            return bce_target_loss(logits, targets)
        return cross_entropy_loss(logits, targets)

    def compute(forward, images, targets, generator):
        # under DDP one call a backward goes through the wrapper, which
        # readies its gradient hooks; a second forward (cosub) runs the model
        # itself, and its gradients reach the same hooks summed
        if cfg.cosub:
            logits1 = forward(images, generator)
            logits2 = model(images, generator)
            return 0.25 * (loss_of(logits1, targets) + loss_of(logits2, targets)
                           + loss_of(logits1, torch.sigmoid(logits2.float()).detach())
                           + loss_of(logits2, torch.sigmoid(logits1.float()).detach()))
        logits = forward(images, generator)
        loss = loss_of(logits, targets)
        if cfg.distillation_type != "none":
            loss = distillation_loss(loss, logits, teacher_apply(images),
                                     distillation_type=cfg.distillation_type,
                                     alpha=cfg.distillation_alpha, tau=cfg.distillation_tau)
        return loss

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                generator: torch.Generator):
        with tracing.span("deit.step", root=state.step):
            return _step(state, images, labels, generator)

    def _step(state, images, labels, generator):
        model.train()
        shard = batch_sharding(state.mesh)
        with tracing.span("deit.mixup"):
            if cfg.mixup_alpha > 0 or cfg.cutmix_alpha > 0:
                draws = draw_mixup(generator, images.shape[1], images.shape[2], cfg.mixup_alpha,
                                   cfg.cutmix_alpha, cfg.mixup_prob, cfg.mixup_switch_prob)
                partner = None
                if draws.apply and shard.count > 1:
                    far_images, far_labels = mirror_block([images, labels], shard)
                    partner = (far_images.flip(0), far_labels.flip(0))
                images, targets = mixup_cutmix(images, labels, cfg.num_classes, draws,
                                               cfg.smoothing, partner)
            else:
                targets = one_hot_smooth(labels, cfg.num_classes, cfg.smoothing)
            if cfg.loss_type == "bce":
                targets = targets.clamp(0.0, 1.0)

        # microbatches (accum_steps > 1) average their gradients into ONE
        # update; mixup ran on the whole batch above
        k = cfg.accum_steps
        if images.shape[0] % k:
            raise ValueError(f"batch {images.shape[0]} not divisible by accum_steps {k}")
        optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=images.device)
        replica = state.replica
        for i, (im, tg) in enumerate(zip(images.chunk(k), targets.chunk(k))):
            # DDP averages the gradients once, after the last microbatch
            quiet = replica.no_sync() if replica is not None and i < k - 1 else \
                contextlib.nullcontext()
            rows = shard.crop_rows(len(im)) if shard.count > 1 else None
            with quiet, global_batch_rows(shard.count * len(im), rows):
                with tracing.span("deit.forward"):
                    micro = compute(replica or model, im, tg, generator)
                with tracing.span("deit.backward"):
                    (micro / k).backward()
            loss = loss + micro.detach() / k

        with tracing.span("deit.update"):
            if trainable_mask is not None:
                for n, p in named:
                    if not trainable_mask[n]:
                        p.grad = None
            with tracing.span("deit.clip"):
                grads = [p.grad for _, p in named if p.grad is not None]
                gnorm = global_norm(grads)
                if cfg.clip_grad is not None:
                    torch._foreach_mul_([sharding.local(g) for g in grads],
                                        torch.clamp(cfg.clip_grad / (gnorm + 1e-6), max=1.0))
            with tracing.span("deit.optimizer"):
                lr = schedule(state.step)
                for group in optimizer.param_groups:
                    group["lr"] = lr
                optimizer.step()
            if state.ema is not None:
                with tracing.span("deit.ema"), torch.no_grad():
                    d = cfg.ema_decay
                    ema = [sharding.local(state.ema[n]) for n, _ in named]
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, [sharding.local(p) for _, p in named], alpha=1 - d)
        state.step += 1
        if shard.count > 1:
            (loss,) = reduce_mean([loss])
        return state, {"loss": loss, "grad_norm": gnorm}

    return step_fn


def make_eval_step(model: nn.Module):
    """eval(images, labels, params=None) -> dict of partial sums (top1,
    top5, n, loss_sum) to accumulate on the host. `params` (name -> tensor,
    e.g. the EMA) replaces the model's own for this call."""

    @torch.no_grad()
    def eval_fn(images, labels, params: Optional[Dict[str, torch.Tensor]] = None):
        model.eval()
        if params is None:
            logits = model(images)
        else:
            logits = torch.func.functional_call(model, params, (images,))
        loss = cross_entropy_loss(logits, labels)
        k = min(5, logits.shape[-1])
        top = logits.topk(k, dim=-1).indices
        n = labels.shape[0]
        return {"top1": (top[:, 0] == labels).sum(), "top5": (top == labels[:, None]).any(-1).sum(),
                "n": torch.tensor(n), "loss_sum": loss * n}

    return eval_fn
