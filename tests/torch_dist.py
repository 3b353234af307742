"""Runs a function in N processes of one gloo group on the CPU, for the port's
multi-process tests, and the functions those tests run there.

``run_processes(fn, world, tmp, *args)`` starts `world` processes with the
``spawn`` method (the pytest process has imported JAX, and a ``fork`` after
that can deadlock), each joining a gloo group through a ``FileStore`` in
`tmp` (six xdist workers run at once: a fixed TCP port would collide), calls
``fn(rank, world, *args)`` and returns each rank's result, in rank order.
The functions run in the children import torch and the port only; the
tests hold what they return against JAX in the parent. Call it under
``tests/torch_time_limit.py``'s ``time_limit``: ``join`` then cannot wait
past the test's limit.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_processes(fn, world: int, tmp, *args) -> list:
    out = os.path.join(str(tmp), f"results_{world}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(str(tmp), f"store_{world}")
    mp.start_processes(_entry, args=(fn, world, store, out, args), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(world)]


# ---- what the children run ----------------------------------------------------------

DEIT_IMG = 32
DEIT_BATCH = 8  # global


def _whole(tree):
    """Every tensor of a dict gathered whole and detached."""
    from octic_vits_tpu_torch.parallel.sharding import full

    return {k: full(v.detach()).clone() for k, v in tree.items()}


def deit_batches(seed: int, steps: int = 2) -> list:
    """Global (images, labels) batches of the DeiT tests, from numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((DEIT_BATCH, DEIT_IMG, DEIT_IMG, 3)).astype(np.float32),
             rng.integers(0, 10, size=DEIT_BATCH).astype(np.int64)) for _ in range(steps)]


def deit_state(sd, cfg_kw: dict, drop_path: float = 0.0):
    """The port's DeiT state of ``hybrid_vit_small_test`` at 32^2 from the
    state dict `sd`, or from seeded weights with LayerScale 1.0 where None
    (so that a block a drop path removes moves the loss)."""
    from octic_vits_tpu_torch import create_model, init_weights
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    model = create_model("hybrid_vit_small_test", img_size=DEIT_IMG, remat=True,
                         drop_path_rate=drop_path, device="cpu",
                         **({} if sd is not None else {"init_scale": 1.0}))
    if sd is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(sd, strict=True)
    cfg = engine.DeiTConfig(**cfg_kw)
    opt = engine.build_optimizer(cfg, model)
    return cfg, common.create_train_state(model, opt, ema=cfg.model_ema)


def deit_run(mode: str, cfg_kw: dict, sd, batches, generators, drop_path: float = 0.0,
             fsdp=None):
    """DeiT steps of the port on this process's share of each global batch,
    the state laid out by `mode` (one process: no layout). Returns the
    metrics and the whole parameters, EMA and LAMB first moments."""
    from octic_vits_tpu_torch.parallel import batch_sharding, create_mesh
    from octic_vits_tpu_torch.parallel.mesh import process_count
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    cfg, state = deit_state(sd, cfg_kw, drop_path)
    mesh = None
    if mode != "one":
        n = process_count()
        mesh = create_mesh(fsdp=fsdp or (1 if mode == "dp" else n), device="cpu")
        common.state_shardings(state, mesh, shard_params=mode == "zero3")
    step = engine.make_deit_train_step(state.model, cfg, state.optimizer)
    shard = batch_sharding(mesh)
    metrics = []
    for (images, labels), seed in zip(batches, generators):
        state, m = step(state, shard(torch.from_numpy(images)), shard(torch.from_numpy(labels)),
                        torch.Generator().manual_seed(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    named = dict(state.model.named_parameters())
    moments = {n: state.optimizer.state[p]["exp_avg"] for n, p in named.items()}
    return {"metrics": metrics, "params": _whole(named), "ema": _whole(state.ema),
            "mu": _whole(moments)}


def deit_worker(rank, world, jax_case, random_case):  # noqa: ARG001
    """Every DeiT case of one group: the JAX-parity runs (one per layout) and
    the runs with mixup, cutmix and drop path on."""
    out = {}
    for mode, fsdp in jax_case["layouts"]:
        out[("jax", mode, fsdp)] = deit_run(mode, jax_case["cfg"], jax_case["sd"],
                                            jax_case["batches"], (0, 1), fsdp=fsdp)
    for mode in random_case["modes"]:
        out[("random", mode)] = deit_run(mode, random_case["cfg"], None, random_case["batches"],
                                         random_case["generators"], random_case["drop_path"])
    out[("accum", "dp")] = deit_run("dp", dict(random_case["cfg"], accum_steps=2), None,
                                    random_case["batches"], random_case["generators"],
                                    random_case["drop_path"])
    return out


def mixup_worker(rank, world, images, labels, cases):  # noqa: ARG001
    """This process's block of each case's mixed images and targets: the
    engine's partner exchange and mixup_cutmix with the given draws."""
    from octic_vits_tpu_torch.data.mixup import mixup_cutmix
    from octic_vits_tpu_torch.parallel.mesh import BatchShard, mirror_block

    shard = BatchShard(rank, world)
    x, y = shard(torch.from_numpy(images)), shard(torch.from_numpy(labels))
    far_x, far_y = mirror_block([x, y], shard)
    return [mixup_cutmix(x, y, 10, draws, smoothing, (far_x.flip(0), far_y.flip(0)))
            for draws, smoothing in cases]


def lamb_worker(rank, world, weights, grads):  # noqa: ARG001
    """LAMB on FSDP2 shards of `weights` (ZeRO-3 over all processes) with
    the given whole gradients, with the whole tensors' trust ratio and, for
    contrast, each shard's own; the global norm of the sharded gradients."""
    from torch import nn

    from octic_vits_tpu_torch.parallel import create_mesh
    from octic_vits_tpu_torch.parallel import sharding
    from octic_vits_tpu_torch.train import optim

    def run(shard_norms: bool):
        module = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                                   for k, v in weights.items()})
        mesh = create_mesh(fsdp=world, device="cpu")
        sharding.fully_shard_module(module, mesh, reshard_after_forward=True)
        params = dict(module.named_parameters())
        opt = optim.Lamb([{"params": list(params.values()), "weight_decay": 0.05}], lr=1e-2,
                         betas=(0.9, 0.99), eps=1e-8)
        if shard_norms:  # what a per-shard norm would give: each shard's own ratio
            opt_norms = optim.norms
            optim.norms = lambda ts, like=None: torch.stack(torch._foreach_norm(
                [sharding.local(t) for t in ts]))
        norm = None
        try:
            for g in grads:
                for k, p in params.items():
                    p.grad = sharding.shard_like(torch.from_numpy(g[k]), p)
                norm = float(sharding.global_norm([p.grad for p in params.values()]))
                opt.step()
        finally:
            if shard_norms:
                optim.norms = opt_norms
        return _whole(params), norm

    (whole, norm), (per_shard, _) = run(False), run(True)
    return {"params": whole, "per_shard": per_shard, "grad_norm": norm}


def centre_worker(rank, world, logits, weights, temp):
    """The centre update and Sinkhorn-Knopp of this process's block of
    `logits` (rows) with the sums over the group."""
    from octic_vits_tpu_torch.parallel.mesh import BatchShard
    from octic_vits_tpu_torch.train.dinov2 import losses as L

    shard, group = BatchShard(rank, world), dist.group.WORLD
    t, w = shard(torch.from_numpy(logits)), shard(torch.from_numpy(weights))
    zero = L.CenterState(torch.zeros(logits.shape[1]))
    return {"center": L.update_center(zero, t, 0.9, group=group).center,
            "center_w": L.update_center(zero, t, 0.9, w > 0, group=group).center,
            "sk": L.sinkhorn_knopp_teacher(t, temp, group=group),
            "sk_w": L.sinkhorn_knopp_teacher(t, temp, sample_mask=w > 0, group=group)}


def small_worker(rank, world, mixup_args, lamb_args, centre_args):
    return {"mixup": mixup_worker(rank, world, *mixup_args),
            "lamb": lamb_worker(rank, world, *lamb_args),
            "centre": centre_worker(rank, world, *centre_args)}


SSL_CFG = dict(arch="hybrid_dinov2_vit_tiny_test", img_size=32, local_crop_size=16, patch_size=8,
               drop_path_rate=0.0, dino_out_dim=64, dino_head_hidden_dim=32,
               dino_head_bottleneck_dim=16, ibot_out_dim=64, n_local_crops=2)
SSL_SCHED = dict(lr=1e-3, wd=0.04, last_layer_lr=5e-4, momentum=0.9, teacher_temp=0.04)
SSL_IMAGES = 8  # global images a batch: 2 crop rows of each a process at 4 processes


def ssl_batches(seed: int, steps: int = 2) -> list:
    """Global collated SSL batches (16 global and 16 local crops, masks),
    from numpy and a seeded ``random.Random``."""
    from octic_vits_tpu_torch.train.dinov2 import masking

    rng, npr = random.Random(seed), np.random.RandomState(seed)
    grid = SSL_CFG["img_size"] // SSL_CFG["patch_size"]
    gen = masking.MaskingGenerator(grid, num_masking_patches=grid * grid // 2)
    s, ls = SSL_CFG["img_size"], SSL_CFG["local_crop_size"]
    out = []
    for _ in range(steps):
        gc = npr.randn(2 * SSL_IMAGES, s, s, 3).astype(np.float32)
        lc = npr.randn(SSL_CFG["n_local_crops"] * SSL_IMAGES, ls, ls, 3).astype(np.float32)
        out.append(masking.collate_crops_and_masks(gc, lc, grid * grid, gen, rng=rng))
    return out


def ssl_run(mode: str, extra: dict, sd, batches, fsdp=None) -> dict:
    """SSL steps of the port on this process's share of each global batch,
    the state laid out by `mode` (one process: no layout). Returns the
    metrics and the whole student, teacher, first moments and centres."""
    from octic_vits_tpu_torch.parallel import create_mesh
    from octic_vits_tpu_torch.parallel.mesh import process_count
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    arch = SSLMetaArch(SSLConfig(**dict(SSL_CFG, **extra), compute_dtype=None), device="cpu")
    student = arch.build_student()
    student.load_state_dict(sd, strict=True)
    state = arch.state_from_student(student)
    mesh = None
    if mode != "one":
        n = process_count()
        mesh = create_mesh(fsdp=fsdp or (1 if mode == "dp" else n), device="cpu")
        arch.state_shardings(state, mesh, shard_params=mode == "zero3")
    step = arch.make_train_step()
    share = arch.batch_shardings(mesh)
    metrics, mu = [], []
    for i, batch in enumerate(batches):
        state, m = step(state, batch_to_device(share(batch), "cpu"), SSL_SCHED,
                        torch.Generator().manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
        mu.append(_whole(state.mu))
    return {"metrics": metrics, "student": _whole(dict(state.student.named_parameters())),
            "teacher": _whole(dict(state.teacher.named_parameters())),
            "mu": mu, "dino_center": state.dino_center.clone(),
            "ibot_center": state.ibot_center.clone()}


def ssl_worker(rank, world, cases, sd_by_case, batches):  # noqa: ARG001
    return {name: ssl_run(mode, extra, sd_by_case[name], batches)
            for name, (mode, extra) in cases.items()}


def tree_equal(a, b) -> bool:
    """Bitwise equality of two state trees (tensors, dicts, lists, scalars)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))
    return a == b


ZERO3_CFG = dict(num_classes=10, warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3)


def zero3_checkpoint_worker(rank, world, directory):  # noqa: ARG001
    """A ZeRO-3 DeiT state takes one step and is saved (process 0 writes);
    returns the state gathered here and whether a fresh sharded state
    restored from the checkpoint gathers to it bitwise."""
    from octic_vits_tpu_torch.parallel import batch_sharding, create_mesh
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine
    from octic_vits_tpu_torch.utils.checkpoint import CheckpointManager, to_host

    def sharded():
        cfg, state = deit_state(None, ZERO3_CFG, drop_path=0.1)
        common.state_shardings(state, create_mesh(fsdp=world, device="cpu"), shard_params=True)
        return cfg, state

    cfg, state = sharded()
    step = engine.make_deit_train_step(state.model, cfg, state.optimizer)
    images, labels = deit_batches(3, 1)[0]
    shard = batch_sharding(state.mesh)
    state, _ = step(state, shard(torch.from_numpy(images)), shard(torch.from_numpy(labels)),
                    torch.Generator().manual_seed(1))
    mgr = CheckpointManager(directory, max_to_keep=2)
    mgr.save(1, state.state_dict())
    gathered = to_host(state.state_dict())
    _, fresh = sharded()
    fresh.load_state_dict(mgr.restore())
    restored_equal = tree_equal(to_host(fresh.state_dict()), gathered)
    mgr.close()
    return {"gathered": gathered, "restored_equal": restored_equal}
