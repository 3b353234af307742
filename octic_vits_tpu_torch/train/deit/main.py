"""DeiT III supervised training loop (counterpart of
octic_vits_tpu/train/deit/main.py; reference: deit/main.py:207-534): the
dataset through RASampler and the loader, the train step, per-epoch
evaluation of the raw and EMA weights, keep-2 checkpoints, the ``best``
export, resume and the SIGTERM save, a json-lines log.

Resume follows the JAX loop: the step count comes from the checkpoint and
the epoch is ``step // steps_per_epoch``; a checkpoint taken mid-epoch
replays that epoch from its start with the count carried on. Each step's
mixup draws and drop-path masks come from a CPU ``torch.Generator`` seeded
from (seed, step) (:func:`step_generator`), as the JAX step folds its step
into its key, so a resumed run draws what the straight run drew.

Under a process group (``torchrun``, ``octic_vits_tpu_torch.launch``) the
loop runs data parallel, as the JAX loop runs on its mesh: the state is laid
out by ``state_shardings`` (DDP), each process samples its shard of each
epoch (``RASampler(shard=rank, num_shards=world)``) and takes
``batch_size // world`` rows of the global batch, the logged metrics are the
processes' mean, and the checkpoints hold whole tensors, written by process
0 alone in the one-process format and restored by every process. Where the
JAX loop shrinks its mesh until it divides the batch, a process cannot sit
idle: a world that does not divide ``batch_size`` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from octic_vits_tpu_torch.data.loaders import DataLoader
from octic_vits_tpu_torch.data.samplers import EpochSampler, RASampler
from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.models.registry import create_model, resolve_device
from octic_vits_tpu_torch.parallel.mesh import (
    any_process,
    create_mesh,
    distributed,
    process_count,
    process_index,
)
from octic_vits_tpu_torch.train.common import create_train_state, state_shardings
from octic_vits_tpu_torch.train.deit.engine import (
    DeiTConfig,
    build_optimizer,
    make_deit_train_step,
    make_eval_step,
)
from octic_vits_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    PreemptionGuard,
    save_tree,
    to_host,
)
from octic_vits_tpu_torch.utils.logging import MetricLogger, maybe_wandb_init, maybe_wandb_log


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`: a pure function of (seed,
    step)."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2**63))


def batch_to_device(images: np.ndarray, labels: np.ndarray, device) -> tuple:
    """A loader batch (NHWC float32 images, int targets) on `device`."""
    return (torch.from_numpy(np.ascontiguousarray(images)).to(device),
            torch.from_numpy(np.asarray(labels)).long().to(device))


def evaluate(model: nn.Module, params, loader, eval_step=None) -> dict:
    """Top-1/top-5/loss over a finite loader (reference: deit/engine.py:99-128);
    `params` (name -> tensor, e.g. the EMA) replaces the model's own, None
    keeps them."""
    eval_step = eval_step or make_eval_step(model)
    device = next(model.parameters()).device
    tot = {"top1": 0, "top5": 0, "n": 0, "loss_sum": 0.0}
    for images, labels in loader:
        out = eval_step(*batch_to_device(images, labels, device), params=params)
        for k in tot:
            tot[k] += float(out[k])
    n = max(tot["n"], 1)
    return {"acc1": 100.0 * tot["top1"] / n, "acc5": 100.0 * tot["top5"] / n,
            "loss": tot["loss_sum"] / n}


def train(model_name: str, cfg: DeiTConfig, train_dataset, val_dataset, output_dir: str,
          img_size: int = 224, seed: int = 0, model_kwargs: Optional[dict] = None,
          num_workers: int = 8, max_steps: Optional[int] = None, finetune: str = "",
          teacher: Optional[nn.Module] = None, metric_flush_every: int = 20, device=None):
    """Train on `device` (the card unless the caller names another) and
    return the final ``TrainState``. `finetune` loads a pretrained checkpoint
    (a reference ``.pth`` or a port checkpoint directory) with head-drop and
    pos-embed interpolation (reference: deit/main.py:282-338); `teacher`, a
    model, enables ``cfg.distillation_type`` (deit/main.py:383-407)."""
    os.makedirs(output_dir, exist_ok=True)
    device = resolve_device(device)
    world, rank = process_count(), process_index()
    main_process = rank == 0
    if cfg.batch_size % world:
        raise ValueError(f"the global batch {cfg.batch_size} does not split over {world} "
                         "processes (the JAX loop shrinks its mesh instead; a process cannot "
                         "sit idle)")
    local_bs = cfg.batch_size // world
    kwargs = dict(model_kwargs or {})
    if device.type == "cuda":
        # the measured train-step configuration on the card (chip_smoke.py
        # P7): f32 parameters, bf16 compute, remat; the octic blocks take
        # their train kernels in train mode and the fused inference kernels
        # in eval mode. The CPU keeps the plain f32 path.
        kwargs.setdefault("compute_dtype", torch.bfloat16)
        kwargs.setdefault("remat", True)
    if cfg.drop:
        kwargs.setdefault("drop_rate", cfg.drop)
    model = create_model(model_name, img_size=img_size, drop_path_rate=cfg.drop_path,
                         num_classes=cfg.num_classes, device=device, **kwargs)
    # schedules are defined in epochs (reference: deit/main.py:368 uses
    # len(data_loader)); steps/epoch come from the dataset, so warmup/cosine
    # and the resume epoch arithmetic agree with the data
    spe = max(1, len(train_dataset) // max(cfg.batch_size, 1))
    if cfg.steps_per_epoch != spe:
        cfg = dataclasses.replace(cfg, steps_per_epoch=spe)
    init_weights(model, torch.Generator(device).manual_seed(seed))
    if finetune:
        from octic_vits_tpu_torch.utils.finetune import load_pretrained_for_finetune

        model.load_state_dict(load_pretrained_for_finetune(finetune, model), strict=True)
    trainable_mask = None
    if cfg.attn_only:
        from octic_vits_tpu_torch.utils.finetune import attn_only_trainable_mask

        trainable_mask = attn_only_trainable_mask(model)
    teacher_apply = None
    if teacher is not None:
        teacher.eval()
        t_dtype = next(teacher.parameters()).dtype

        @torch.no_grad()
        def teacher_apply(x):
            return teacher(x.to(t_dtype))

    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, ema=cfg.model_ema)
    if distributed():
        state_shardings(state, create_mesh(device=device))
    step = make_deit_train_step(model, cfg, optimizer, teacher_apply=teacher_apply,
                                trainable_mask=trainable_mask)
    eval_step = make_eval_step(model)

    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"), max_to_keep=2)
    guard = PreemptionGuard()
    try:
        restored = ckpt.restore()
        if restored is not None:
            state.load_state_dict(restored)
            del restored
        logger = MetricLogger(output_file=os.path.join(output_dir, "log.txt")
                              if main_process else None)
        if main_process:
            maybe_wandb_init("octic-vits-deit", config=dataclasses.asdict(cfg))
        sampler = RASampler(len(train_dataset), shard=rank, num_shards=world, seed=seed,
                            repetitions=3 if cfg.repeated_aug else 1)
        best_acc = 0.0
        host_step = state.step
        start_epoch = host_step // max(cfg.steps_per_epoch, 1)

        # Deferred metric sync: .item() waits for the card, so metrics are
        # flushed in windows and the host keeps enqueuing steps meanwhile
        pending: list = []

        def flush():
            for m in pending:
                vals = {k: float(v) for k, v in m.items()}
                if not np.isfinite(vals["loss"]):
                    raise RuntimeError(f"NaN/Inf loss at step {host_step}: {vals}")
                logger.update(**vals)
            pending.clear()

        def val_loader():
            # every process evaluates the whole set, as the JAX loop's hosts do
            return DataLoader(val_dataset, EpochSampler(len(val_dataset)),
                              batch_size=local_bs, num_workers=num_workers,
                              drop_last=False)

        for epoch in range(start_epoch, cfg.epochs):
            sampler.set_epoch(epoch)
            tf = getattr(train_dataset, "transform", None)
            if hasattr(tf, "set_epoch"):
                tf.set_epoch(epoch)  # a fresh per-sample augment stream each epoch
            loader = DataLoader(train_dataset, sampler, batch_size=local_bs,
                                num_workers=num_workers)
            for images, labels in logger.log_every(loader, 50, f"Epoch {epoch}"):
                images, labels = batch_to_device(images, labels, device)
                state, metrics = step(state, images, labels, step_generator(seed, host_step))
                host_step += 1
                pending.append(metrics)
                synced = len(pending) >= metric_flush_every
                if synced:
                    flush()
                if max_steps and host_step >= max_steps:
                    break
                # the processes agree at the flushes (one sync); alone, every step
                if (guard.preempted if world == 1 else
                        synced and any_process(guard.preempted, device)):
                    break
            flush()
            preempted = any_process(guard.preempted, device)

            host = ckpt.save(host_step, state.state_dict(), force=preempted)
            if preempted:
                ckpt.wait()
                print("preempted; checkpoint saved", flush=True)
                return state

            if val_dataset is not None:
                stats = evaluate(model, None, val_loader(), eval_step)
                line = {"epoch": epoch, **stats}
                # the paper reports the EMA model's accuracy: evaluate it every
                # epoch and select "best" on it (reference: deit/main.py:344-351,
                # 482-511)
                select_acc = stats["acc1"]
                if state.ema is not None:
                    ema_stats = evaluate(model, state.ema, val_loader(), eval_step)
                    line.update({f"ema_{k}": v for k, v in ema_stats.items()})
                    select_acc = ema_stats["acc1"]
                    print(f"* EMA Acc@1 {ema_stats['acc1']:.3f} Acc@5 {ema_stats['acc5']:.3f} "
                          f"loss {ema_stats['loss']:.3f}", flush=True)
                print(f"* Acc@1 {stats['acc1']:.3f} Acc@5 {stats['acc5']:.3f} "
                      f"loss {stats['loss']:.3f}", flush=True)
                if main_process:
                    with open(os.path.join(output_dir, "log.txt"), "a") as f:
                        f.write(json.dumps(line) + "\n")
                    maybe_wandb_log(line, step=host_step)
                if select_acc > best_acc:
                    best_acc = select_acc
                    # the whole state: raw and EMA weights travel in the export;
                    # the host copy of this epoch's checkpoint is that state
                    if host is None:
                        host = (to_host(state.state_dict()) if main_process
                                else to_host(state.state_dict(), keep=False))
                    if main_process:
                        save_tree(os.path.join(output_dir, "best"), host)
            del host
            if max_steps and host_step >= max_steps:
                break

        ckpt.wait()
        return state
    finally:
        guard.close()
        ckpt.close()
