"""DINOv2 SSL losses (counterpart of octic_vits_tpu/train/dinov2/losses.py).

The centering buffers are explicit state handed to and returned by the step.
Softmaxes, logs and the Sinkhorn iterations run in f32 whatever the logits'
dtype.

Under data parallelism each process holds some rows of the global batch.
The centre and Sinkhorn-Knopp take means and sums over the global batch
(the JAX step's over its sharded batch axis): given a process `group` they
all-reduce their sums over it (the reference's all_reduce). The losses are
means over a process's rows, whose mean over equal processes is the global
mean; :func:`koleo_loss_per_device` is the per-GPU KoLeo and
:func:`koleo_loss_global` the KoLeo over the gathered global batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the processes of `group` (itself for None)."""
    if group is not None:
        t = t.clone()
        dist.all_reduce(t, group=group)
    return t


class CenterState(NamedTuple):
    """EMA center of the teacher logits (DINO cls or iBOT patch)."""

    center: torch.Tensor  # [D] f32


def softmax_center_teacher(teacher_logits: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float) -> torch.Tensor:
    """softmax((t - center) / temp) in f32."""
    return torch.softmax((teacher_logits.float() - center) / teacher_temp, dim=-1)


def update_center(state: CenterState, teacher_logits: torch.Tensor, momentum: float = 0.9,
                  weights: Optional[torch.Tensor] = None, group=None) -> CenterState:
    """EMA of the batch mean of the teacher logits; `weights` (0/1) keeps
    only the valid rows of the padded iBOT buffer. With a process `group`
    the mean is over the rows of every process (one all-reduce)."""
    t = teacher_logits.float().reshape(-1, teacher_logits.shape[-1])
    if group is None:
        if weights is None:
            batch_center = t.mean(0)
        else:
            w = weights.float().reshape(-1, 1)
            batch_center = (t * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    else:
        w = (torch.ones(len(t), 1, device=t.device) if weights is None
             else weights.float().reshape(-1, 1))
        sums = _sum(torch.cat(((t * w).sum(0), w.sum().reshape(1))), group)
        batch_center = sums[:-1] / torch.clamp(sums[-1], min=1.0)
    return CenterState(state.center * momentum + batch_center * (1.0 - momentum))


def sinkhorn_knopp_teacher(teacher_logits: torch.Tensor, teacher_temp: float,
                           n_iterations: int = 3,
                           sample_mask: Optional[torch.Tensor] = None,
                           group=None) -> torch.Tensor:
    """Sinkhorn-Knopp assignment in f32; `sample_mask` gives the padded rows
    of the iBOT buffer no mass. With a process `group` the sums over samples
    run over every process's rows (the reference's all_reduce)."""
    q = torch.exp(teacher_logits.float() / teacher_temp).t()  # [K, B]
    k, b = q.shape
    if sample_mask is not None:
        m = sample_mask.float()
        q = q * m[None, :]
        n_samples = torch.clamp(_sum(m.sum(), group), min=1.0)
    else:
        n_samples = _sum(torch.tensor(float(b), device=q.device), group)
    q = q / _sum(q.sum(), group)
    for _ in range(n_iterations):
        q = q / _sum(q.sum(1, keepdim=True), group)
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


def koleo_loss_per_device(student_cls: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """KoLeo with the reference's per-GPU batch scope (koleo_loss.py:38-48):
    the nearest neighbours of this process's rows searched among its own rows
    (no gather). This is the process's term; the JAX function's ``pmean``
    over the mesh is the step's mean over the processes (of the gradients,
    by DDP or FSDP, and of the logged loss)."""
    return koleo_loss(student_cls, eps)


def koleo_loss_global(student_cls: torch.Tensor, group=None,
                      eps: float = 1e-8) -> torch.Tensor:
    """KoLeo with the nearest neighbours searched over the global batch: the
    rows of every process of `group` all-gathered in rank order (with a
    gradient), then :func:`koleo_loss` of the whole; JAX's ``koleo_global``
    on its global batch. The gather's backward sums the cotangents of every
    process, each of which holds the same global loss, so a process's rows
    get `world` times the loss's gradient; the step's mean of the gradients
    over the processes (DDP, FSDP2) then leaves the global loss's gradient
    once. Without a group it is :func:`koleo_loss`."""
    if group is None:
        return koleo_loss(student_cls, eps)
    from torch.distributed.nn.functional import all_gather

    return koleo_loss(torch.cat(all_gather(student_cls.contiguous(), group=group)), eps)
