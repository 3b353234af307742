"""The ``(data, fsdp)`` device mesh over torch processes (counterpart of
octic_vits_tpu/parallel/mesh.py).

JAX builds one ``Mesh`` of devices and lets XLA place the collectives; here
each device is a process (rank) and the mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
with rank r at JAX's device position r: ``arange(n).reshape(n // fsdp,
fsdp)``. The ``data`` axis carries the gradient all-reduce (DDP), the
``fsdp`` axis the parameter and optimizer-state shards (FSDP2); the batch is
split over both axes, each rank holding one contiguous block of the global
batch (:func:`batch_sharding`, JAX's ``P(("data", "fsdp"))``).

Without a process group every function here describes a world of one
process: ``process_index() == 0``, ``process_count() == 1``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def distributed() -> bool:
    """Whether a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def mesh_layout(n: int, fsdp: int = 1) -> np.ndarray:
    """The ranks of an ``(n // fsdp, fsdp)`` mesh: rank r at JAX's device
    position r (``np.asarray(devices).reshape(n // fsdp, fsdp)``)."""
    if fsdp < 1 or n % fsdp:
        raise ValueError(f"{n} processes not divisible by fsdp={fsdp}")
    return np.arange(n).reshape(n // fsdp, fsdp)


def hybrid_mesh_layout(n: int, local_world: int, fsdp: int = 1) -> np.ndarray:
    """The node-aware layout: JAX's slice-major mesh with nodes for slices.
    torchrun numbers ranks node by node (node k holds ranks k L .. k L + L -
    1 for L processes a node), so :func:`mesh_layout` already lays the data
    axis node-major; what JAX asserts of a slice is checked of a node: the
    ``fsdp`` axis must stay inside one node (NVLink, not the network)."""
    if local_world < 1 or n % local_world:
        raise ValueError(f"{n} processes are not whole nodes of {local_world}")
    if local_world % fsdp:
        raise ValueError(f"fsdp={fsdp} must divide the {local_world} processes of one node "
                         "(parameter all-gathers must not cross nodes)")
    return mesh_layout(n, fsdp)


def mesh_device_type(device=None) -> str:
    """The mesh's device type: the device the caller names, else the CUDA
    card when the process group runs NCCL, else the CPU."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if distributed() and dist.get_backend() == "nccl" else "cpu"


def _device_mesh(layout: np.ndarray, device=None):
    from torch.distributed.device_mesh import DeviceMesh

    if not distributed():
        raise RuntimeError("a device mesh needs a process group: run under torchrun "
                           "(octic_vits_tpu_torch.launch) or call init_process_group")
    if layout.size != process_count():
        raise ValueError(f"a mesh of {layout.size} ranks over a world of {process_count()}")
    return DeviceMesh(mesh_device_type(device), torch.as_tensor(layout),
                      mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def create_mesh(fsdp: int = 1, device=None):
    """2-D ``(data, fsdp)`` mesh over every process. ``fsdp=1`` is pure data
    parallelism (DDP); ``fsdp=k`` shards parameters and optimizer state over
    groups of k consecutive ranks (ZeRO / FSDP SHARD_GRAD_OP) while the
    gradients still reach every rank. Keep `fsdp` within one node."""
    return _device_mesh(mesh_layout(process_count(), fsdp), device)


def create_hybrid_mesh(fsdp: int = 1, device=None):
    """:func:`create_mesh` with the fsdp groups checked to lie inside one node
    (``LOCAL_WORLD_SIZE`` processes, torchrun's), as JAX keeps them inside one
    ICI domain; on one node it is :func:`create_mesh`."""
    n = process_count()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return _device_mesh(hybrid_mesh_layout(n, local, fsdp), device)


def mesh_shape(mesh) -> tuple:
    """(data, fsdp) sizes of `mesh`; (1, 1) for no mesh."""
    if mesh is None:
        return 1, 1
    return mesh.size(0), mesh.size(1)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Which block of a global batch this process holds: block `index` of
    `count` equal contiguous blocks of the leading axis."""

    index: int = 0
    count: int = 1

    def local_size(self, global_size: int) -> int:
        if global_size % self.count:
            raise ValueError(f"a batch of {global_size} does not split over {self.count} "
                             "processes")
        return global_size // self.count

    def rows(self, global_size: int) -> slice:
        n = self.local_size(global_size)
        return slice(self.index * n, (self.index + 1) * n)

    def __call__(self, x):
        """This process's block of a global array or tensor."""
        return x[self.rows(len(x))]

    def crop_rows(self, b: int, n_crops: int = 1) -> torch.Tensor:
        """The global rows of this process's `b` images in a crop-major batch
        of `n_crops` crops of ``count * b`` images: crop c of image i of block
        k is row ``c * count * b + k * b + i`` (one crop: the block itself)."""
        total = self.count * b
        return (torch.arange(n_crops)[:, None] * total + self.index * b
                + torch.arange(b)[None, :]).reshape(-1)


def batch_sharding(mesh) -> BatchShard:
    """The batch axis split over the whole mesh (both axes): rank r's block
    is its position in the mesh, r."""
    if mesh is None:
        return BatchShard()
    if not torch.equal(mesh.mesh.flatten().cpu(), torch.arange(mesh.mesh.numel())):
        raise ValueError(f"a mesh whose positions are not its ranks: {mesh.mesh.tolist()}")
    return BatchShard(process_index(), mesh.mesh.numel())


def mirror_block(tensors: list, shard: BatchShard) -> list:
    """The blocks of `tensors` that the process at the mirror position
    (``count - 1 - index``) holds: global row i's partner in the reversed
    batch, B - 1 - i, lies there, at local row b - 1 - j for local row j.
    One send and one receive each with that process; the tensors
    themselves where the position is its own mirror."""
    peer = shard.count - 1 - shard.index
    if peer == shard.index:
        return list(tensors)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, peer), dist.P2POp(dist.irecv, buf, peer)]
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def replicated(mesh) -> BatchShard:  # noqa: ARG001
    """Whole on every process."""
    return BatchShard()


def reduce_mean(tensors: list, group=None) -> list:
    """The mean over the processes of each of `tensors` (0-d or alike), in one
    all-reduce; the tensors themselves where there is one process."""
    if not distributed() or dist.get_world_size(group) == 1:
        return tensors
    flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
    dist.all_reduce(flat, group=group)  # gloo has no AVG
    return list((flat / dist.get_world_size(group)).unbind())


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The tensors `t` of every process of `group` (the default group where
    None) stacked in rank order, ``[world, *t.shape]``: one all-gather where
    the tensors live (each process gives the same shape and dtype)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def any_process(flag: bool, device=None) -> bool:
    """Whether `flag` holds on any process (a MAX all-reduce); `flag` itself
    where there is one process. Waits for the processes: call it where the
    loop syncs anyway."""
    if not distributed() or process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], device=mesh_device_type(device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    """Every process waits for the others; nothing where there is one."""
    if distributed() and process_count() > 1:
        dist.barrier()


def same_on_every_process(values: tuple) -> bool:
    """Whether every process holds the same tuple of ints."""
    if not distributed() or process_count() == 1:
        return True
    seen = [None] * process_count()
    dist.all_gather_object(seen, tuple(int(v) for v in values))
    return all(s == seen[0] for s in seen)
