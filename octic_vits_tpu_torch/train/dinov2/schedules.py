"""Training schedules of the DINOv2 recipe, on the host in numpy (the port's
own copy of octic_vits_tpu/train/dinov2/schedules.py)."""

from __future__ import annotations

import numpy as np


class CosineScheduler:
    """Precomputed cosine schedule with optional freeze and linear warmup
    segments; past ``total_iters`` it stays at ``final_value``."""

    def __init__(self, base_value: float, final_value: float, total_iters: int,
                 warmup_iters: int = 0, start_warmup_value: float = 0.0, freeze_iters: int = 0):
        self.final_value = final_value
        self.total_iters = total_iters
        freeze = np.zeros((freeze_iters,))
        warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
        n = total_iters - warmup_iters - freeze_iters
        it = np.arange(n)
        cos = final_value + 0.5 * (base_value - final_value) * (1 + np.cos(np.pi * it / max(n, 1)))
        self.schedule = np.concatenate((freeze, warmup, cos))
        if len(self.schedule) != total_iters:
            raise ValueError("freeze and warmup longer than the schedule")

    def __getitem__(self, it: int) -> float:
        if it >= self.total_iters:
            return float(self.final_value)
        return float(self.schedule[it])


def build_ssl_schedules(cfg):
    """(lr, wd, momentum, teacher_temp, last_layer_lr) schedules from a
    config with the recipe's ``train``, ``optim`` and ``teacher`` sections."""
    ep_len = cfg.train.OFFICIAL_EPOCH_LENGTH
    total = cfg.optim.epochs * ep_len
    warmup = cfg.optim.warmup_epochs * ep_len

    def lr_like():
        return CosineScheduler(cfg.optim.lr, cfg.optim.min_lr, total, warmup_iters=warmup,
                               start_warmup_value=0)

    lr = lr_like()
    wd = CosineScheduler(cfg.optim.weight_decay, cfg.optim.weight_decay_end, total)
    momentum = CosineScheduler(cfg.teacher.momentum_teacher, cfg.teacher.final_momentum_teacher,
                               total)
    temp_iters = cfg.teacher.warmup_teacher_temp_epochs * ep_len
    teacher_temp = CosineScheduler(cfg.teacher.teacher_temp, cfg.teacher.teacher_temp,
                                   temp_iters, warmup_iters=temp_iters,
                                   start_warmup_value=cfg.teacher.warmup_teacher_temp)
    last_layer_lr = lr_like()
    last_layer_lr.schedule[: cfg.optim.freeze_last_layer_epochs * ep_len] = 0
    return lr, wd, momentum, teacher_temp, last_layer_lr


def sqrt_lr_scaling(base_lr: float, global_batch_size: int) -> float:
    """The sqrt_wrt_1024 rule: lr scaled by sqrt(batch / 1024)."""
    return base_lr * (global_batch_size / 1024.0) ** 0.5
