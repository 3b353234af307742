"""The DINOv2 SSL step: ``SSLMetaArch`` as the DINOv2 trainer builds it from
the default recipe and the configuration's training file
(``configs/train/<file>.yaml``) with ``train.batch_size_per_gpu`` set by the
mix, stepped on a pool of seeded multi-crop batches (2 global and
``n_local_crops`` local crops an image, iBOT masks on a share of the global
crops) with the trainer's per-iteration generator and the schedule's values
that the mix names. The window enqueues steps back to back and waits for the
device where the trainer reads its metrics (every ``sync_every`` steps).

Set-up drives the one state through its first ``check_steps`` steps with the
window's own call and feed, on batches that all differ, and keeps each
step's total loss, each student parameter's gradient norm as AdamW got it at
the first step (its first moment over 1 - beta1), and each parameter's
change after the last, the student's and the teacher's. The reference
follows the same steps."""

from __future__ import annotations

import math
import os

import torch

from benchmark import flops, weights
from benchmark.compare import train_gaps
from benchmark.reference import octic_vit
from benchmark.reference import ssl_step as ref_step
from benchmark.reference.leaves import leaf_norms
from benchmark.window import Window, paced_steps


def upper_bound(crops: int, tokens: int, probability: float, ratios: tuple) -> int:
    """The most tokens the recipe's masking can mask in `crops` global crops:
    the masked crops' ratios step evenly from the low to the high end."""
    n = int(crops * probability)
    step = (ratios[1] - ratios[0]) / n
    return int(sum(int(tokens * (ratios[0] + step * (i + 1))) for i in range(n)))


def draw_masks(gen: torch.Generator, crops: int, tokens: int, probability: float,
               ratios: tuple) -> torch.Tensor:
    """bool ``[crops, tokens]``: a `probability` share of the crops masked,
    the i-th of them at a ratio between the i-th and the next of evenly
    spaced ratios, its tokens drawn at random; the crops in shuffled order."""
    n = int(crops * probability)
    step = (ratios[1] - ratios[0]) / n
    masks = torch.zeros(crops, tokens, dtype=torch.bool)
    for i in range(n):
        ratio = ratios[0] + step * (i + float(torch.rand((), generator=gen)))
        masks[i, torch.randperm(tokens, generator=gen)[:int(tokens * ratio)]] = True
    return masks[torch.randperm(crops, generator=gen)]


def masked_buffers(masks: torch.Tensor, length: int) -> dict:
    """The flat indices of the masked tokens padded with 0 to `length`, each
    one's weight (1 over its crop's count; 0 on the padding), their count."""
    flat = masks.flatten().nonzero().flatten()
    weight = (1.0 / masks.sum(-1).clamp(min=1).float())[flat // masks.shape[1]]
    idx = torch.zeros(length, dtype=torch.long)
    w = torch.zeros(length)
    idx[:len(flat)], w[:len(flat)] = flat, weight
    return {"mask_indices": idx, "masks_weight": w,
            "n_masked_patches": torch.tensor(len(flat), dtype=torch.int32)}


def halve(batch: dict, n_local: int) -> dict:
    """The batch of the first half of its images: each crop group's first half,
    their masks and masked-token buffers (a planted fault: half of the batch
    left out, the loss a mean over the rest)."""
    b = batch["global_crops"].shape[0] // 2

    def rows(groups):
        return torch.cat([torch.arange(i * b, i * b + b // 2) for i in range(groups)])

    g = rows(2)
    masks = batch["masks"][g.to(batch["masks"].device)]
    out = {"global_crops": batch["global_crops"][g.to(batch["global_crops"].device)],
           "local_crops": batch["local_crops"][rows(n_local).to(batch["local_crops"].device)],
           "masks": masks, **masked_buffers(masks.cpu(), len(batch["mask_indices"]))}
    return {k: v.to(batch["masks"].device) for k, v in out.items()}


def ssl_config(arch_cls, config_dir: str, train_file: str, opts: list):
    """The trainer's ``SSLConfig`` (``train/dinov2/cli.py``) of the default
    recipe, the training file and the overrides `opts`."""
    from octic_vits_tpu_torch.utils.config import build_config, load_yaml

    c = build_config(load_yaml(os.path.join(config_dir, "ssl_default_config.yaml")),
                     os.path.join(config_dir, "train", train_file), opts)
    return arch_cls(
        arch=c.student.arch, img_size=c.crops.global_crops_size,
        local_crop_size=c.crops.local_crops_size, patch_size=c.student.patch_size,
        drop_path_rate=c.student.drop_path_rate, dino_out_dim=c.dino.head_n_prototypes,
        dino_head_hidden_dim=c.dino.head_hidden_dim,
        dino_head_bottleneck_dim=c.dino.head_bottleneck_dim,
        dino_head_nlayers=c.dino.head_nlayers, dino_loss_weight=c.dino.loss_weight,
        koleo_loss_weight=c.dino.koleo_loss_weight, ibot_out_dim=c.ibot.head_n_prototypes,
        ibot_separate_head=c.ibot.separate_head, ibot_loss_weight=c.ibot.loss_weight,
        centering=c.train.centering, n_local_crops=c.crops.local_crops_number,
        clip_grad=c.optim.clip_grad, layerwise_decay=c.optim.layerwise_decay,
        patch_embed_lr_mult=c.optim.patch_embed_lr_mult,
        compute_dtype=torch.bfloat16 if c.compute_precision.compute_dtype == "bfloat16" else None,
        backbone_remat=bool(c.student.get("remat", True)))


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.images_per_step = mix["batch"]
        self.pending: list = []
        self.losses: list = []

    def batches(self) -> list:
        """The pool: global and local crops made on the device from the seed, and
        masks drawn on the host from it."""
        m, b = self.mix, self.mix["batch"]
        gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        host = torch.Generator().manual_seed(self.seed + 2)
        g, s = m["img_size"], m["local_size"]
        tokens = (g // self.config["patch_size"]) ** 2
        ratios = tuple(m["mask_ratios"])
        length = upper_bound(2 * b, tokens, m["mask_probability"], ratios)
        pool = []
        for _ in range(m["pool"]):
            masks = draw_masks(host, 2 * b, tokens, m["mask_probability"], ratios)
            batch = {"global_crops": torch.randn(2 * b, g, g, 3, generator=gen,
                                                 device=self.device),
                     "local_crops": torch.randn(m["n_local_crops"] * b, s, s, 3, generator=gen,
                                                device=self.device),
                     "masks": masks, **masked_buffers(masks, length)}
            pool.append({k: v.to(self.device) for k, v in batch.items()})
        return pool

    def setup(self) -> None:
        from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch
        from octic_vits_tpu_torch.train.dinov2.train import iteration_generator
        from octic_vits_tpu_torch.utils.config import CONFIG_DIR

        opts = [f"train.batch_size_per_gpu={self.mix['batch']}"] + self.config["train_overrides"]
        arch = SSLMetaArch(ssl_config(SSLConfig, CONFIG_DIR, self.config["train_file"], opts),
                           device=self.device)
        student = arch.build_student()
        self.shapes = weights.shapes_of(student)
        weights.load_into(student, weights.seeded(self.shapes, self.config["weights"], self.seed,
                                                  self.device))
        self.state = arch.state_from_student(student)
        self.step_fn = arch.make_train_step()
        self.iteration_generator = iteration_generator
        self.sched = {k: self.mix["recipe"][k]
                      for k in ("lr", "wd", "last_layer_lr", "momentum", "teacher_temp")}
        self.pool = self.batches()
        self.readings = self.check_steps()

    def step(self, i: int) -> None:
        st = self.state
        self.state, metrics = self.step_fn(st, self.pool[i % len(self.pool)], self.sched,
                                           self.iteration_generator(self.seed, st.step))
        self.pending.append(metrics["total_loss"])

    def sync(self) -> None:
        """Read the pending losses, as the trainer reads its metrics."""
        self.losses += [float(v) for v in self.pending]
        self.pending.clear()

    def check_steps(self) -> dict:
        b1 = self.mix["recipe"]["betas"][0]
        losses, grad = [], None
        for i in range(self.mix["check_steps"]):
            self.step(i)
            self.sync()
            losses.append(self.losses.pop())
            if grad is None:
                grad = {n: v / (1 - b1) for n, v in leaf_norms(self.state.mu.items()).items()}
        p0 = weights.seeded(self.shapes, self.config["weights"], self.seed, self.device)
        out = {"losses": losses, "grad": grad}
        with torch.no_grad():
            for key, module in (("change", self.state.student),
                                ("teacher_change", self.state.teacher)):
                out[key] = leaf_norms((n, p.detach() - p0[n]) for n, p in module.named_parameters())
        return out

    def window(self, seconds: float) -> Window:
        base = self.mix["check_steps"]
        return paced_steps(lambda i: self.step(base + i), self.sync, seconds,
                           self.mix["sync_every"])

    def flops_per_image(self) -> float:
        """The student's forward and backward of every crop (3 forwards), the
        teacher's forward of the global crops, and the DINO head over the
        rows each pass feeds it (the padded masked-patch buffer included)."""
        m, c = self.mix, self.config
        local = 2 * flops.vit_macs(dict(c, img_size=m["local_size"]))
        glob = 2 * flops.vit_macs(dict(c, img_size=m["img_size"]))
        tokens = (m["img_size"] // c["patch_size"]) ** 2
        masked = upper_bound(2 * m["batch"], tokens, m["mask_probability"],
                             tuple(m["mask_ratios"])) / m["batch"]
        head = 2 * flops.dino_head_macs(c)
        return (3 * m["n_local_crops"] * local + 4 * 2 * glob
                + (3 * (m["n_local_crops"] + 2 + masked) + (2 + masked)) * head)

    def end_to_end(self, win: Window) -> dict:
        return {"ssl_img_s": win.rate(self.images_per_step)}

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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p0 = weights.seeded(self.shapes, self.config["weights"], self.seed, self.device)
        batches = self.pool[:self.mix["check_steps"]]
        if half_batch:
            batches = [halve(b, self.mix["n_local_crops"]) for b in batches]
        return ref_step.run(p0, self.config, self.mix["recipe"], batches, self.seed,
                            quant or octic_vit.ident, self.mix["reference_chunk"],
                            self.mix["reference_local_chunk"])

    def check(self, limits: dict) -> tuple:
        """({name: {"value", "limit"}}, attempted, failed): a window step
        fails when its loss is not finite."""
        self.ref_readings = self.reference()
        numbers = train_gaps(self.readings, self.ref_readings)
        checks = {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
                  for k, v in numbers.items()}
        failed = sum(not math.isfinite(v) for v in self.losses)
        return checks, len(self.losses), failed
