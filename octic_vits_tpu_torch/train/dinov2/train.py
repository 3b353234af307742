"""DINOv2 SSL training loop (counterpart of
octic_vits_tpu/train/dinov2/train.py; reference: dinov2/train/train.py:140-361):
the schedules, the SSL step, metrics, the periodic teacher export and keep-3
checkpoints; deterministic data resume through the sampler's ``advance``.

Each iteration's drop-path masks come from a CPU ``torch.Generator`` seeded
from (seed + 1, iteration), as the JAX step folds its step into its key.

Under a process group (``torchrun``, ``octic_vits_tpu_torch.launch``) the
loop runs data parallel over a ``(data, 1)`` mesh, as the JAX loop's mesh of
every device: each process collates its own batch of ``batch_size_per_gpu``
images from its shard of the stream (the reference's per-GPU batch), so the
global batch is ``world`` of them and nothing has to divide. The JAX loop
sizes its mesh from the first batch and shrinks it until it divides the
crops; here a process cannot sit idle, and a first batch whose shapes differ
between processes raises ``ValueError``. Process 0 alone writes logs,
checkpoints and teacher exports.
"""

from __future__ import annotations

import itertools
import os
import random
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from octic_vits_tpu_torch.parallel.mesh import (
    any_process,
    create_mesh,
    distributed,
    process_index,
    same_on_every_process,
)
from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator, collate_crops_and_masks
from octic_vits_tpu_torch.train.dinov2.schedules import build_ssl_schedules
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLMetaArch, SSLState, batch_to_device
from octic_vits_tpu_torch.utils.checkpoint import CheckpointManager, PreemptionGuard, save_teacher
from octic_vits_tpu_torch.utils.logging import MetricLogger, maybe_wandb_init, maybe_wandb_log


def ssl_batch_iterator(dataset, sampler_iter: Iterator[int], augmenter, batch_size: int,
                       n_tokens: int, mask_generator: MaskingGenerator,
                       mask_probability: float = 0.5, mask_ratio_tuple=(0.1, 0.5),
                       rng: Optional[random.Random] = None):
    """Yields static-shape SSL batches: the multicrop augmentation of each
    image, serially in the caller's thread as the JAX package does, then the
    collate with the iBOT masks."""
    rng = rng or random.Random(0)
    while True:
        crops = []
        for _ in range(batch_size):
            image, _ = dataset[next(sampler_iter)]
            crops.append(augmenter(image, rng=rng))
        n_g = len(crops[0]["global_crops"])
        n_l = len(crops[0]["local_crops"])
        gc = np.stack([c["global_crops"][i] for i in range(n_g) for c in crops])
        lc = np.stack([c["local_crops"][i] for i in range(n_l) for c in crops])
        yield collate_crops_and_masks(gc, lc, n_tokens, mask_generator,
                                      mask_probability=mask_probability,
                                      mask_ratio_tuple=mask_ratio_tuple, rng=rng)


def iteration_generator(seed: int, it: int) -> torch.Generator:
    """The CPU generator of iteration `it`: a pure function of (seed, it)."""
    return torch.Generator().manual_seed(((seed + 1) * 1_000_003 + it) % (2**63))


def do_train(arch: SSLMetaArch, cfg, batch_iter: Optional[Iterator], output_dir: str,
             max_iter: Optional[int] = None, state: Optional[SSLState] = None,
             log_every: int = 10, seed: int = 0,
             make_batch_iter: Optional[Callable[[int], Iterator]] = None, resume: bool = True,
             eval_only: bool = False) -> SSLState:
    """Train and return the final ``SSLState``. `batch_iter` yields collated
    numpy batches (see :func:`ssl_batch_iterator`); `cfg` is a ConfigNode
    with the recipe's train/optim/teacher sections.

    `make_batch_iter(start_iter)`, when given, supersedes `batch_iter` and is
    called after the checkpoint restore, so that the data stream continues
    where the restored run left off (the reference's ``sampler_advance``,
    dinov2/data/samplers.py:174-182). `resume=False` skips the restore;
    `eval_only=True` restores, exports the teacher and returns without
    training (reference train.py:30-64)."""
    lr_s, wd_s, mom_s, temp_s, last_lr_s = build_ssl_schedules(cfg)
    max_iter = max_iter or cfg.optim.epochs * cfg.train.OFFICIAL_EPOCH_LENGTH

    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"), max_to_keep=3,
                             save_interval_steps=cfg.train.get("saveckp_freq_iterations",
                                                               3 * 1250))
    guard = PreemptionGuard()
    try:
        if state is None:
            state = arch.init(torch.Generator(arch.device).manual_seed(seed))
            if resume:
                restored = ckpt.restore()
                if restored is not None:
                    state.load_state_dict(restored)
                    del restored
        if eval_only:
            save_teacher(output_dir, state.step, state.teacher_state_dict())
            return state
        if make_batch_iter is not None:
            batch_iter = make_batch_iter(state.step)
        main_process = process_index() == 0
        if distributed():
            first = next(batch_iter)
            batch_iter = itertools.chain([first], batch_iter)
            if not same_on_every_process(first["global_crops"].shape
                                         + first["local_crops"].shape
                                         + first["mask_indices"].shape):
                raise ValueError("the processes' first batches differ in shape: every process "
                                 "must collate the same batch_size_per_gpu")
            arch.state_shardings(state, create_mesh(device=arch.device))
        logger = MetricLogger(output_file=os.path.join(output_dir, "training_metrics.json")
                              if main_process else None)
        if main_process:
            maybe_wandb_init("octic-vits-dinov2")
        step = arch.make_train_step()
        eval_period = cfg.get("evaluation", {}).get("eval_period_iterations", 12500)
        t_end = time.time()
        for it in range(state.step, max_iter):
            batch = next(batch_iter)
            data_time = time.time() - t_end
            batch = batch_to_device(batch, arch.device)
            sched = {"lr": lr_s[it], "wd": wd_s[it], "momentum": mom_s[it],
                     "teacher_temp": temp_s[it], "last_layer_lr": last_lr_s[it]}
            state, metrics = step(state, batch, sched, iteration_generator(seed, it))

            synced = it % log_every == 0
            if synced:
                host_metrics = {k: float(v.detach()) for k, v in metrics.items()}
                if not np.isfinite(host_metrics["total_loss"]):
                    raise RuntimeError(f"NaN/Inf loss at iter {it}: {host_metrics}")
                logger.update(lr=sched["lr"], wd=sched["wd"], mom=sched["momentum"],
                              **host_metrics)
                if main_process:
                    maybe_wandb_log(host_metrics, step=it)
                    logger.dump_in_output_file(it, time.time() - t_end, data_time)
                    print(f"iter {it}: {logger}", flush=True)

            if (it + 1) % eval_period == 0:
                save_teacher(output_dir, it + 1, state.teacher_state_dict())
            # the interval gate comes before any copy: the host copy of the
            # whole state is GBs at ViT-L and must not run on every iteration
            if ckpt.should_save(it + 1):
                ckpt.save(it + 1, state.state_dict())

            # the processes agree where the loop syncs anyway; alone, every iteration
            if (synced and any_process(guard.preempted, arch.device) if distributed()
                    else guard.preempted):
                ckpt.save(it + 1, state.state_dict(), force=True)
                ckpt.wait()
                print(f"preempted at iter {it + 1}; checkpoint saved", flush=True)
                break
            t_end = time.time()

        ckpt.wait()
        return state
    finally:
        guard.close()
        ckpt.close()
