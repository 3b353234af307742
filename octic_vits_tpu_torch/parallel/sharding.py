"""Parameter and optimizer-state sharding (counterpart of
octic_vits_tpu/parallel/sharding.py).

The rule is JAX's, shape-driven: a tensor is sharded over the ``fsdp`` axis
along its largest axis that the axis size divides; tensors under 2**15
elements stay whole (:func:`leaf_partition_spec`). Under FSDP2 the rule is
the ``shard_placement_fn`` of ``fully_shard``. FSDP2 keeps no parameter of a
sharded module whole, so the tensors that JAX keeps whole are sharded on
their first axis (FSDP2 pads an uneven split): another layout, the same
numbers.

A sharded tensor is a ``DTensor``; the step's arithmetic runs on its local
shard (:func:`local`). Where a whole tensor's norm is needed (the gradient
clip, LAMB's trust ratio), :func:`norms` adds the shards' squares over the
processes: ``torch._foreach_norm`` of a DTensor gives each process the norm
of its own shard.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

MIN_ELEMENTS = 2**15


def leaf_partition_spec(shape: Sequence[int], size: int,
                        min_elements: int = MIN_ELEMENTS) -> Optional[int]:
    """The axis of `shape` to shard over an fsdp axis of `size`, or None
    (whole): the largest axis that `size` divides, the last of equals, as
    JAX's ``max((d, i))``."""
    if size == 1 or not shape or math.prod(shape) < min_elements:
        return None
    cands = [(d, i) for i, d in enumerate(shape) if d % size == 0]
    return max(cands)[1] if cands else None


def fsdp_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(1)


def tree_shardings(module: nn.Module, mesh,
                   min_elements: int = MIN_ELEMENTS) -> Dict[str, Optional[int]]:
    """Parameter name -> the axis it is sharded along over `mesh`'s fsdp
    axis, or None (whole)."""
    size = fsdp_size(mesh)
    return {n: leaf_partition_spec(tuple(p.shape), size, min_elements)
            for n, p in module.named_parameters()}


def replicated_tree(module: nn.Module, mesh) -> Dict[str, Optional[int]]:  # noqa: ARG001
    return {n: None for n, _ in module.named_parameters()}


def shard_placement_fn(mesh, min_elements: int = MIN_ELEMENTS):
    """``fully_shard``'s placement of each parameter: :func:`leaf_partition_spec`'s
    axis, the first axis where that keeps the tensor whole."""
    size = fsdp_size(mesh)

    def place(param: nn.Parameter):
        axis = leaf_partition_spec(tuple(param.shape), size, min_elements)
        return Shard(0 if axis is None else axis)

    return place


# ---- sharded tensors ------------------------------------------------------------


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The process's own part of `t`: a DTensor's local shard (the tensor it
    holds: in-place ops on it update the DTensor; ``to_local()`` would add an
    autograd node a call, ~600 a step), any other tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of `t`: a DTensor gathered (a collective: every process of
    its mesh calls it, in the same order), any other tensor itself."""
    return t.full_tensor() if is_dtensor(t) else t


def shard_like(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`whole` laid out as `like`: a DTensor with `like`'s mesh and
    placements whose local shard is cut from `whole` here (no communication),
    or `whole` on `like`'s device where `like` is a plain tensor."""
    whole = whole.to(device=local(like).device, dtype=like.dtype)
    if not is_dtensor(like):
        return whole
    return distribute_tensor(whole, like.device_mesh, like.placements, src_data_rank=None)


def _shard_group(t):
    """The process group that `t`'s shards span, or None (whole)."""
    dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    if not dims or all(t.device_mesh.size(i) == 1 for i in dims):
        return None
    if len(dims) > 1:
        raise NotImplementedError("a tensor sharded over several mesh axes")
    return t.device_mesh.get_group(dims[0])


def norms(tensors: Sequence[torch.Tensor],
          like: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The 2-norm of each whole tensor of `tensors` ``[n]`` f32, whole
    tensors or DTensor shards alike: the local norms, and for the sharded
    ones the square root of their squares summed over the shard group (one
    all-reduce a group). `like`, where given, holds the DTensors whose
    layout `tensors` (then local shards) have. Where no tensor is split over
    more than one process it is ``torch._foreach_norm`` itself, bit for bit."""
    n = torch.stack(torch._foreach_norm([local(t) for t in tensors])).float()
    groups: dict = {}
    for i, t in enumerate(tensors if like is None else like):
        g = _shard_group(t) if is_dtensor(t) else None
        if g is not None:
            groups.setdefault(g, []).append(i)
    for g, idx in groups.items():
        at = torch.tensor(idx, device=n.device)
        sq = n[at].square()
        dist.all_reduce(sq, group=g)
        n = n.index_put((at,), sq.sqrt())
    return n


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: the 2-norm of all of `tensors` together."""
    return torch.linalg.vector_norm(norms(tensors))


@torch.no_grad()
def load_full_(dst: torch.Tensor, whole: torch.Tensor) -> None:
    """Copy the whole tensor `whole` into `dst`, whole or a DTensor shard."""
    if is_dtensor(dst):
        local(dst).copy_(local(shard_like(whole, dst)))
    else:
        dst.copy_(whole)


def load_module_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state, strict=True)``, also for a module whose
    parameters are DTensors: each then takes its shard of the whole tensor in
    `state`."""
    own = module.state_dict(keep_vars=True)
    if not any(is_dtensor(t) for t in own.values()):
        module.load_state_dict(state, strict=True)
        return
    missing, unexpected = own.keys() - state.keys(), state.keys() - own.keys()
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
    for name, t in own.items():
        load_full_(t, state[name])


# ---- laying modules out over a mesh ----------------------------------------------


def fully_shard_module(module: nn.Module, mesh, reshard_after_forward: bool,
                       forward_methods: Sequence[str] = ()) -> nn.Module:
    """FSDP2 over `mesh`'s fsdp axis (HSDP over both axes where the data
    axis has more than one rank), in place: each block of ``module.blocks``
    a unit of its own, so that only one block's parameters are whole at a
    time, then the rest of `module`. ``reshard_after_forward`` frees the
    whole parameters after the forward (ZeRO-3) or keeps them for the
    backward (ZeRO-2, SHARD_GRAD_OP). `forward_methods` are methods other
    than ``forward`` that callers run (``forward_features``): FSDP2 gathers
    around them too."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from octic_vits_tpu_torch.parallel.mesh import FSDP_AXIS

    fmesh = mesh if mesh.size(0) > 1 else mesh[FSDP_AXIS]
    kw = dict(mesh=fmesh, reshard_after_forward=reshard_after_forward,
              shard_placement_fn=shard_placement_fn(mesh))
    for blk in getattr(module, "blocks", ()):
        fully_shard(blk, **kw)
    fully_shard(module, **kw)
    for name in forward_methods:
        register_fsdp_forward_method(module, name)
    return module


def data_parallel(module: nn.Module, mesh) -> nn.Module:
    """DDP of `module` over `mesh`'s data axis (its fsdp axis one rank):
    gradients averaged over the processes in buckets during the backward."""
    from torch.nn.parallel import DistributedDataParallel

    from octic_vits_tpu_torch.parallel.mesh import DATA_AXIS

    dev = next(module.parameters()).device
    ids = None if dev.type != "cuda" else [torch.cuda.current_device() if dev.index is None
                                           else dev.index]
    return DistributedDataParallel(module, device_ids=ids, process_group=mesh.get_group(DATA_AXIS),
                                   broadcast_buffers=False)


def shard_tensors_like(tensors: Dict[str, torch.Tensor],
                       params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each of `tensors` (EMA values, moments; by parameter name) laid out as
    the parameter of its name."""
    return {n: shard_like(full(t), params[n]) for n, t in tensors.items()}


def remap_optimizer_(optimizer: torch.optim.Optimizer, old: Dict[str, torch.Tensor],
                     new: Dict[str, torch.Tensor]) -> None:
    """Point `optimizer` at the parameters that replaced its own (FSDP2
    replaces each parameter with a sharded one): `old` and `new` by name.
    Its state, if any, moves to the new parameters, laid out as they are."""
    name_of = {id(p): n for n, p in old.items()}
    for group in optimizer.param_groups:
        group["params"] = [new[name_of[id(p)]] for p in group["params"]]
    moved = {}
    for p, st in optimizer.state.items():
        q = new[name_of[id(p)]]
        moved[q] = {k: shard_like(full(v), q) if _moment_of(v, p) else v for k, v in st.items()}
    optimizer.state.clear()
    optimizer.state.update(moved)


def _moment_of(v, p) -> bool:
    return isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(p.shape) and v.ndim > 0


def shard_optimizer_state_(optimizer: torch.optim.Optimizer) -> None:
    """After ``optimizer.load_state_dict`` of whole tensors: lay each moment
    out as its parameter (a no-op for whole parameters)."""
    for p, st in optimizer.state.items():
        if is_dtensor(p):
            for k, v in st.items():
                if _moment_of(v, p) and not is_dtensor(v):
                    st[k] = shard_like(v, p)
