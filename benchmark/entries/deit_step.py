"""The DeiT III train step: the model, optimizer, state and step that the
DeiT III trainer builds (``train/deit/main.py``: the recipe's ``DeiTConfig``
defaults, and on the card bf16 compute over f32 parameters with per-block
remat), stepped on a pool of seeded batches with the trainer's per-step
generator. The window enqueues steps back to back and waits for the device
where the trainer reads its metrics (every ``sync_every`` steps).

Set-up drives the one state through its first ``check_steps`` steps with the
window's own call and feed, on batches that all differ, and keeps each
step's loss, each parameter's gradient norm as the optimizer got it at the
first step (its first moment over 1 - beta1), each parameter's change after
the last and its EMA's change. The reference follows the same steps."""

from __future__ import annotations

import importlib
import math

import torch

from benchmark import flops, weights
from benchmark.compare import train_gaps
from benchmark.reference import deit_step as ref_step
from benchmark.reference.leaves import leaf_norms
from benchmark.window import Window, paced_steps

class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.images_per_step = mix["batch"]
        self.pending: list = []
        self.losses: list = []

    def setup(self) -> None:
        from octic_vits_tpu_torch import create_model
        from octic_vits_tpu_torch.train.common import create_train_state
        from octic_vits_tpu_torch.train.deit.engine import (
            DeiTConfig,
            build_optimizer,
            make_deit_train_step,
        )
        from octic_vits_tpu_torch.train.deit.main import step_generator

        cfg = DeiTConfig(num_classes=self.config["num_classes"])
        card = dict(compute_dtype=torch.bfloat16, remat=True) if self.device.type == "cuda" else {}
        model = create_model(self.config["registry"], img_size=self.mix["img_size"],
                             drop_path_rate=cfg.drop_path, num_classes=cfg.num_classes,
                             device=self.device, **card)
        self.shapes = weights.shapes_of(model)
        weights.load_into(model, weights.seeded(self.shapes, self.config["weights"], self.seed,
                                                self.device))
        opt = build_optimizer(cfg, model)
        self.state = create_train_state(model, opt, ema=cfg.model_ema)
        self.state.step = self.mix["recipe"]["start_step"]
        self.step_fn = make_deit_train_step(model, cfg, opt)
        self.step_generator = step_generator
        gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        s, b = self.mix["img_size"], self.mix["batch"]
        self.pool = [(torch.randn(b, s, s, 3, generator=gen, device=self.device),
                      torch.randint(0, cfg.num_classes, (b,), generator=gen, device=self.device))
                     for _ in range(self.mix["pool"])]
        self.readings = self.check_steps(opt)

    def step(self, i: int) -> None:
        images, labels = self.pool[i % len(self.pool)]
        st = self.state
        self.state, metrics = self.step_fn(st, images, labels,
                                           self.step_generator(self.seed, st.step))
        self.pending.append(metrics["loss"])

    def sync(self) -> None:
        """Read the pending losses, as the trainer flushes its metrics."""
        self.losses += [float(v) for v in self.pending]
        self.pending.clear()

    def check_steps(self, opt) -> dict:
        named = list(self.state.model.named_parameters())
        losses, grad = [], None
        for i in range(self.mix["check_steps"]):
            self.step(i)
            self.sync()
            losses.append(self.losses.pop())
            if grad is None:
                beta1 = opt.param_groups[0]["betas"][0]
                # a parameter the optimizer did not move has no moment: nought
                moments = [(n, opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                           for n, p in named]
                grad = {n: v / (1 - beta1) for n, v in leaf_norms(moments).items()}
        p0 = weights.seeded(self.shapes, self.config["weights"], self.seed, self.device)
        out = {"losses": losses, "grad": grad}
        with torch.no_grad():
            out["change"] = leaf_norms((n, p.detach() - p0[n]) for n, p in named)
            if self.state.ema is not None:
                ema = self.state.ema
                out["ema_change"] = leaf_norms((n, ema[n] - p0[n]) for n, _ in named)
        del p0
        return out

    def window(self, seconds: float) -> Window:
        base = self.mix["check_steps"]
        return paced_steps(lambda i: self.step(base + i), self.sync, seconds,
                           self.mix["sync_every"])

    def flops_per_image(self) -> float:
        """A forward and its backward: three forwards' FLOPs."""
        return 3 * flops.flops_per_image(dict(self.config, img_size=self.mix["img_size"]))

    def end_to_end(self, win: Window) -> dict:
        return {"train_img_s": win.rate(self.images_per_step)}

    def trace_window(self) -> int:
        for i in range(self.mix["trace_steps"]):
            self.step(i)
        self.sync()
        return self.mix["trace_steps"] * self.images_per_step

    def release(self) -> None:
        self.sync()
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None, half_batch: bool = False) -> dict:
        ref = importlib.import_module(f"benchmark.reference.{self.config['reference']}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p0 = weights.seeded(self.shapes, self.config["weights"], self.seed, self.device)
        batches = self.pool[:self.mix["check_steps"]]
        return ref_step.run(p0, self.config, self.mix["recipe"], batches, self.seed, ref.forward,
                            quant or ref.ident, self.mix["reference_chunk"], half_batch)

    def check(self, limits: dict) -> tuple:
        """({name: {"value", "limit"}}, attempted, failed): a window step
        fails when its loss is not finite."""
        self.ref_readings = self.reference()
        numbers = train_gaps(self.readings, self.ref_readings)
        checks = {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
                  for k, v in numbers.items()}
        failed = sum(not math.isfinite(v) for v in self.losses)
        return checks, len(self.losses), failed
