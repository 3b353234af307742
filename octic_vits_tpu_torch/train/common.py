"""Train state and losses shared by the recipes (counterpart of
octic_vits_tpu/train/common.py). The JAX state is an immutable tuple of
trees; here it holds the model (its parameters), the optimizer (its state)
and the EMA copy, and a step updates them in place."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> EMA value

    def state_dict(self) -> dict:
        """The state as a tree of references, no copy (``utils.checkpoint``
        copies it to the host): step, model, optimizer and EMA."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_state_dict(self, tree: dict) -> None:
        """Copy a tree of :meth:`state_dict`'s layout into this state."""
        if (tree["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint and the state disagree on the EMA")
        self.model.load_state_dict(tree["model"], strict=True)
        self.optimizer.load_state_dict(tree["optimizer"])
        if self.ema is not None:
            with torch.no_grad():
                for name, t in self.ema.items():
                    t.copy_(tree["ema"][name])
        self.step = int(tree["step"])


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema: bool = False) -> TrainState:
    copy = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    return TrainState(step=0, model=model, optimizer=optimizer, ema=copy)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """labels: int class ids ``[B]`` or soft targets ``[B, K]``; f32 math."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.ndim == logits.ndim:
        targets = labels.float()
    else:
        targets = F.one_hot(labels.long(), logits.shape[-1]).float()
        if label_smoothing:
            targets = targets * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    return -(targets * logp).sum(-1).mean()


def bce_target_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy against (possibly mixed) multi-label targets,
    averaged over every element: the DeiT III default loss."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())
