"""Inference: the registry model in eval mode with the inference path's flags
(parameters and activations in the mix's dtype, every other flag at its
default), as the smoke script's inference phase builds it. One client in a
closed loop sends the batches of a pool of seeded images in turn and waits
for each batch's logits on the host.

The check compares every answer of the window, row by row, with the plain
reference's answer for its batch (the logits, or for a model without a head
the normed cls token, the mix's ``answer``): the number is the widest
relative L2 gap of a row."""

from __future__ import annotations

import importlib
import time

import torch

from benchmark import flops, weights
from benchmark.window import Window, closed_loop, percentile


def row_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative L2 gap of each row of `got` from `ref` (float64)."""
    got, ref = got.double(), ref.double()
    return (got - ref).norm(dim=-1) / ref.norm(dim=-1)


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.images_per_step = mix["batch"]
        self.answers: list = []

    def setup(self) -> None:
        from octic_vits_tpu_torch import create_model

        dt = getattr(torch, self.mix["dtype"])
        self.model = create_model(self.config["registry"], img_size=self.mix["img_size"],
                                  dtype=dt, device=self.device).eval()
        self.shapes = weights.shapes_of(self.model)
        weights.load_into(self.model, weights.seeded(self.shapes, self.config["weights"],
                                                     self.seed, self.device))
        gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        s, b = self.mix["img_size"], self.mix["batch"]
        self.pool = [torch.randn(b, s, s, 3, generator=gen, device=self.device).to(dt)
                     for _ in range(self.mix["pool"])]
        sink: list = []
        for i in range(self.mix["warmup"]):
            self.request(i, sink)

    @torch.inference_mode()
    def request(self, i: int, out: list) -> float:
        """Request i (batch i of the pool, in turn) to its logits on the host;
        returns the host seconds until the forward returned."""
        k = i % len(self.pool)
        t0 = time.perf_counter()
        logits = self.model(self.pool[k])
        dispatch = time.perf_counter() - t0
        out.append((k, logits.float().cpu()))
        return dispatch

    def window(self, seconds: float) -> Window:
        return closed_loop(lambda i: self.request(i, self.answers), seconds)

    def flops_per_image(self) -> float:
        return flops.flops_per_image(dict(self.config, img_size=self.mix["img_size"]))

    def end_to_end(self, win: Window) -> dict:
        """``<metrics>_img_s`` and ``<metrics>_p95_ms``: the mix's ``metrics``
        names its own pair (``infer`` where it names none)."""
        pre = self.mix.get("metrics", "infer")
        return {f"{pre}_img_s": win.rate(self.images_per_step),
                f"{pre}_p95_ms": percentile(win.latency_s, 95) * 1e3}

    def trace_window(self) -> int:
        sink: list = []
        for i in range(self.mix["trace_steps"]):
            self.request(i, sink)
        return self.mix["trace_steps"] * self.images_per_step

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def reference_logits(self, quant=None) -> list:
        """The plain reference's logits ``[B, classes]`` of each pool batch (on
        the host), from the weights drawn again from the seed; `quant` rounds
        the operands of its products (the control)."""
        ref = importlib.import_module(f"benchmark.reference.{self.config['reference']}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = weights.seeded(self.shapes, self.config["weights"], self.seed, self.device)
        chunk = self.mix["reference_chunk"]
        out = []
        for images in self.pool:
            parts = [ref.forward(p, self.config, images[s:s + chunk].float(), quant or ref.ident)
                     for s in range(0, images.shape[0], chunk)]
            out.append(torch.cat(parts).cpu())
        return out

    def check(self, limits: dict) -> tuple:
        """({name: {"value", "limit"}}, attempted, failed): an answer fails when
        a row lies further from the reference than the limit."""
        refs = self.ref_answers = self.reference_logits()
        name = f"{self.mix.get('answer', 'logit')}_gap"
        limit = limits.get(name, {}).get("limit")
        worst, failed = 0.0, 0
        for k, got in self.answers:
            same = got.shape == refs[k].shape
            gap = float(row_gaps(got, refs[k]).max()) if same else float("inf")
            worst = max(worst, gap)
            failed += int(limit is None or not gap <= limit)
        return {name: {"value": worst, "limit": limit}}, len(self.answers), failed
