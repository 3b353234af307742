"""Job launch (counterpart of octic_vits_tpu/launch.py): the torchrun
bootstrap and the one entry that dispatches to a training module.

JAX runs the same program on every host and ``jax.distributed.initialize``
finds the others; here torchrun starts one process a GPU and names the world
in the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
:func:`bootstrap_distributed` reads it, sets the process's CUDA device and
starts the default process group: NCCL for a CUDA device, gloo for the CPU,
as the caller's device says. Where no environment names a world it stays one
process, as JAX's does. Preemption stays in-process
(``utils.checkpoint.PreemptionGuard``), as in the JAX package.

    python -m torch.distributed.run --standalone --nproc_per_node 8 \\
        -m octic_vits_tpu_torch.launch octic_vits_tpu_torch.train.deit.cli \\
        --model hybrid_deit_huge_patch14 --data-set IMAGEFOLDER --data-path DIR \\
        --batch-size 2048 --output_dir OUT

``--device cpu`` among the training module's arguments runs every process
on the CPU over gloo (``--nproc_per_node`` processes on one host).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
from typing import List, Mapping, Optional

import torch
import torch.distributed as dist

from octic_vits_tpu_torch.parallel.mesh import process_index


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    address: str
    port: int


def world_from_env(environ: Optional[Mapping[str, str]] = None) -> Optional[World]:
    """The world torchrun names in `environ` (``os.environ`` by default), or
    None where it names none (no ``WORLD_SIZE``)."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" not in env:
        return None
    world = int(env["WORLD_SIZE"])
    rank = int(env.get("RANK", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} outside WORLD_SIZE={world}")
    return World(rank=rank, world_size=world, local_rank=int(env.get("LOCAL_RANK", "0")),
                 local_world_size=int(env.get("LOCAL_WORLD_SIZE", str(world))),
                 address=env.get("MASTER_ADDR", "localhost"),
                 port=int(env.get("MASTER_PORT", "29500")))


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def bootstrap_distributed(device=None, environ: Optional[Mapping[str, str]] = None,
                          world: Optional[World] = None) -> Optional[World]:
    """Start the default process group of the world in the environment (or
    `world`) on `device`, the CUDA card unless the caller names another; set
    the process's CUDA device to its ``LOCAL_RANK``. Returns the world, or
    None where no world is named (one process, no group). A failed start
    raises: nothing falls back to another backend."""
    world = world if world is not None else world_from_env(environ)
    if world is None:
        return None
    device = torch.device("cuda" if device is None else device)
    backend = backend_for(device)
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the processes on the CPU")
        torch.cuda.set_device(world.local_rank)
        kwargs["device_id"] = torch.device("cuda", world.local_rank)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{world.address}:{world.port}",
                                rank=world.rank, world_size=world.world_size, **kwargs)
    where = kwargs.get("device_id", device)
    print(f"launch: rank {dist.get_rank()} of {dist.get_world_size()}, backend "
          f"{dist.get_backend()}, device {where}", flush=True)
    return world


def is_main_process() -> bool:
    return process_index() == 0


def device_argument(argv: List[str]) -> Optional[str]:
    """The value of ``--device`` among a training module's arguments."""
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return None


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("octic-vits-tpu launcher (torch)")
    parser.add_argument("training_module",
                        help="module with a main(argv) entry, e.g. "
                             "octic_vits_tpu_torch.train.deit.cli, "
                             "octic_vits_tpu_torch.train.dinov2.cli or "
                             "octic_vits_tpu_torch.scripts.eval_dinov2")
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of rank 0 (default: torchrun's MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="world size (default: torchrun's WORLD_SIZE)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (default: torchrun's RANK)")
    args, rest = parser.parse_known_args(argv)

    env = dict(os.environ)
    if args.coordinator:
        env["MASTER_ADDR"], env["MASTER_PORT"] = args.coordinator.rsplit(":", 1)
    if args.num_processes is not None:
        env["WORLD_SIZE"] = str(args.num_processes)
    if args.process_id is not None:
        env["RANK"] = str(args.process_id)
    world = bootstrap_distributed(device_argument(rest), environ=env)
    try:
        module = importlib.import_module(args.training_module)
        return module.main(rest)
    finally:
        if world is not None and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
