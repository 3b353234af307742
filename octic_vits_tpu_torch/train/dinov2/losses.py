"""DINOv2 SSL losses (counterpart of octic_vits_tpu/train/dinov2/losses.py).

The centering buffers are explicit state handed to and returned by the step.
Softmaxes, logs and the Sinkhorn iterations run in f32 whatever the logits'
dtype. ``koleo_loss_per_device`` (the per-GPU batch scope) waits for the
port's data parallelism.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class CenterState(NamedTuple):
    """EMA center of the teacher logits (DINO cls or iBOT patch)."""

    center: torch.Tensor  # [D] f32


def softmax_center_teacher(teacher_logits: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float) -> torch.Tensor:
    """softmax((t - center) / temp) in f32."""
    return torch.softmax((teacher_logits.float() - center) / teacher_temp, dim=-1)


def update_center(state: CenterState, teacher_logits: torch.Tensor, momentum: float = 0.9,
                  weights: Optional[torch.Tensor] = None) -> CenterState:
    """EMA of the batch mean of the teacher logits; `weights` (0/1) keeps
    only the valid rows of the padded iBOT buffer."""
    t = teacher_logits.float().reshape(-1, teacher_logits.shape[-1])
    if weights is None:
        batch_center = t.mean(0)
    else:
        w = weights.float().reshape(-1, 1)
        batch_center = (t * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    return CenterState(state.center * momentum + batch_center * (1.0 - momentum))


def sinkhorn_knopp_teacher(teacher_logits: torch.Tensor, teacher_temp: float,
                           n_iterations: int = 3,
                           sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinkhorn-Knopp assignment in f32; `sample_mask` gives the padded rows
    of the iBOT buffer no mass."""
    q = torch.exp(teacher_logits.float() / teacher_temp).t()  # [K, B]
    k, b = q.shape
    if sample_mask is not None:
        m = sample_mask.float()
        q = q * m[None, :]
        n_samples = torch.clamp(m.sum(), min=1.0)
    else:
        n_samples = torch.tensor(float(b), device=q.device)
    q = q / q.sum()
    for _ in range(n_iterations):
        q = q / q.sum(1, keepdim=True)
        q = q / k
        q = q / torch.clamp(q.sum(0, keepdim=True), min=1e-30)
        q = q / n_samples
    return (q * n_samples).t()


def dino_loss(student_logits_list: Sequence[torch.Tensor],
              teacher_probs_list: Sequence[torch.Tensor],
              student_temp: float = 0.1) -> torch.Tensor:
    """Sum over every (student, teacher) pair of the mean cross entropy."""
    total = 0.0
    for s in student_logits_list:
        lsm = torch.log_softmax(s.float() / student_temp, dim=-1)
        for t in teacher_probs_list:
            total = total - (t * lsm).sum(-1).mean()
    return total


def ibot_patch_loss_masked(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                           masks_weight: torch.Tensor, n_samples: int,
                           student_temp: float = 0.1) -> torch.Tensor:
    """iBOT cross entropy over the padded masked-patch buffer ``[U, D]``;
    `masks_weight` is 0 on the padding."""
    lsm = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    return -((teacher_probs * lsm).sum(-1) * masks_weight).sum() / n_samples


def ibot_patch_loss_dense(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                          masks: torch.Tensor, student_temp: float = 0.1) -> torch.Tensor:
    """Dense variant over ``[B, N, D]`` logits and ``[B, N]`` bool masks."""
    lsm = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    per_token = (teacher_probs * lsm).sum(-1)
    m = masks.float()
    return -((per_token * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)).mean()


def koleo_loss(student_cls: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Kozachenko-Leonenko nearest-neighbour entropy regulariser in f32, with
    the neighbours searched over the whole array it is given."""
    x = student_cls.float()
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    n = x.shape[0]
    dots = x @ x.t() - 2.0 * torch.eye(n, device=x.device)  # exclude self (max dot 1)
    nn_idx = dots.argmax(1)
    diffs = x - x[nn_idx]
    dists = torch.sqrt(diffs.square().sum(-1) + eps * eps)
    return -torch.log(dists + eps).mean()
