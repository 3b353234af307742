"""Train state and losses shared by the recipes (counterpart of
octic_vits_tpu/train/common.py). The JAX state is an immutable tuple of
trees; here it holds the model (its parameters), the optimizer (its state)
and the EMA copy, and a step updates them in place.

:func:`state_shardings` lays a state out over a ``(data, fsdp)`` mesh of
processes (``parallel.create_mesh``), as the JAX function's shardings lay
it over devices: DDP where the fsdp axis has one rank (data parallel),
FSDP2 over the fsdp axis otherwise, the moments sharded with the
parameters kept whole through the step (ZeRO-2) or sharded too
(``shard_params``, ZeRO-3). The EMA follows the parameters' layout. A step
of a laid-out state computes what the one-process step computes on the
global batch (each process's loss is the mean over equal local batches,
and the gradients are averaged over the processes)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from octic_vits_tpu_torch.parallel import sharding
from octic_vits_tpu_torch.parallel.mesh import mesh_shape


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> EMA value
    mesh: Any = None                   # the DeviceMesh it is laid out on (state_shardings)
    replica: Optional[nn.Module] = None  # the DDP wrapper of `model` under data parallelism

    def state_dict(self) -> dict:
        """The state as a tree of references, no copy (``utils.checkpoint``
        copies it to the host, gathering sharded tensors): step, model,
        optimizer and EMA."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_state_dict(self, tree: dict) -> None:
        """Copy a tree of :meth:`state_dict`'s layout, of whole tensors, into
        this state, each sharded tensor taking its shard."""
        if (tree["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint and the state disagree on the EMA")
        sharding.load_module_state(self.model, tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        sharding.shard_optimizer_state_(self.optimizer)
        if self.ema is not None:
            for name, t in self.ema.items():
                sharding.load_full_(t, tree["ema"][name])
        self.step = int(tree["step"])


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema: bool = False) -> TrainState:
    copy = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    return TrainState(step=0, model=model, optimizer=optimizer, ema=copy)


def use_fsdp2(mesh, shard_params: bool, fsdp2: Optional[bool]) -> bool:
    """FSDP2 where the fsdp axis has more than one rank or the parameters are
    sharded; DDP for data parallelism. `fsdp2` forces one or the other (on
    one card, FSDP2's path with a fsdp axis of one rank)."""
    if fsdp2 is None:
        return mesh_shape(mesh)[1] > 1 or shard_params
    if not fsdp2 and mesh_shape(mesh)[1] > 1:
        raise ValueError("DDP keeps every parameter whole: the fsdp axis must have one rank")
    return fsdp2


def state_shardings(state: TrainState, mesh, shard_params: bool = False,
                    fsdp2: Optional[bool] = None) -> TrainState:
    """Lay `state` out over `mesh` in place and return it: data parallel
    (DDP over the data axis, ``state.replica``) where the fsdp axis has one
    rank; else FSDP2 over the fsdp axis, the parameters whole from the
    forward to the backward (ZeRO-2) or gathered again for the backward
    (`shard_params`, ZeRO-3), the moments and the EMA sharded as the
    parameters (`fsdp2`: see :func:`use_fsdp2`). Build the step after this:
    FSDP2 replaces the parameters, and the optimizer is pointed at the new
    ones here."""
    if mesh is None:
        return state
    if not use_fsdp2(mesh, shard_params, fsdp2):
        state.replica = sharding.data_parallel(state.model, mesh)
    else:
        old = dict(state.model.named_parameters())
        sharding.fully_shard_module(state.model, mesh, reshard_after_forward=shard_params)
        new = dict(state.model.named_parameters())
        sharding.remap_optimizer_(state.optimizer, old, new)
        if state.ema is not None:
            state.ema = sharding.shard_tensors_like(state.ema, new)
    state.mesh = mesh
    return state


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
