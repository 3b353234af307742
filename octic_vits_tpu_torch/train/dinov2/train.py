"""DINOv2 SSL training loop (counterpart of
octic_vits_tpu/train/dinov2/train.py; reference: dinov2/train/train.py:140-361):
the schedules, the SSL step, metrics, the periodic teacher export and keep-3
checkpoints; deterministic data resume through the sampler's ``advance``.

One process on one device: the JAX loop's mesh sizing waits for the port's
data parallelism. Each iteration's drop-path masks come from a CPU
``torch.Generator`` seeded from (seed + 1, iteration), as the JAX step folds
its step into its key.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

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
        logger = MetricLogger(output_file=os.path.join(output_dir, "training_metrics.json"))
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

            if it % log_every == 0:
                host_metrics = {k: float(v.detach()) for k, v in metrics.items()}
                if not np.isfinite(host_metrics["total_loss"]):
                    raise RuntimeError(f"NaN/Inf loss at iter {it}: {host_metrics}")
                maybe_wandb_log(host_metrics, step=it)
                logger.update(lr=sched["lr"], wd=sched["wd"], mom=sched["momentum"],
                              **host_metrics)
                logger.dump_in_output_file(it, time.time() - t_end, data_time)
                print(f"iter {it}: {logger}", flush=True)

            if (it + 1) % eval_period == 0:
                save_teacher(output_dir, it + 1, state.teacher_state_dict())
            # the interval gate comes before any copy: the host copy of the
            # whole state is GBs at ViT-L and must not run on every iteration
            if ckpt.should_save(it + 1):
                ckpt.save(it + 1, state.state_dict())

            if guard.preempted:
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
