"""DeiT distillation loss (counterpart of octic_vits_tpu/train/deit/losses.py):
wraps a base loss with soft-KL or hard-CE distillation against a frozen
teacher's logits. Unused by the paper recipe (``distillation_type='none'``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def distillation_loss(base_loss: torch.Tensor, student_logits: torch.Tensor,
                      teacher_logits: Optional[torch.Tensor], distillation_type: str = "none",
                      alpha: float = 0.5, tau: float = 1.0) -> torch.Tensor:
    if distillation_type == "none" or teacher_logits is None:
        return base_loss
    t = teacher_logits.detach().float()
    s = student_logits.float()
    if distillation_type == "soft":
        # KL(teacher || student) * tau^2, batch mean
        log_p_s = F.log_softmax(s / tau, dim=-1)
        log_p_t = F.log_softmax(t / tau, dim=-1)
        distill = (log_p_t.exp() * (log_p_t - log_p_s)).sum(-1).mean() * tau * tau
    elif distillation_type == "hard":
        logp = F.log_softmax(s, dim=-1)
        distill = -logp.gather(-1, t.argmax(-1, keepdim=True)).mean()
    else:
        raise ValueError(distillation_type)
    return base_loss * (1.0 - alpha) + distill * alpha
