"""CUDA-event times of the attention and linear kernels at the ViT-H/14 shapes
of ``chip_smoke.py``, for comparing two trees on one card:

    python3 octic_vits_tpu_torch/tools/time_kernels.py [--root DIR]

It times the tree at DIR (default: the current directory; it imports DIR's
``chip_smoke`` and ``octic_vits_tpu_torch``, so DIR's own kernels are built
and run): the forward kernels of P2 and the train-path kernels of P5 (B=64
and B=32, with bias), and P11's, P15's and P18's B=64 kernels (the fused
glue, the packed container, the wide qkv; P15's and P18's B=32 ones too, and
P8's fused qkv + attention backward at ViT-H/14 B=32) where that tree's
``chip_smoke.py`` has them: every kernel that runs K-attn-bwd is there (rows
1b, 2b, 5, 10, 12 and 13a). P2's four kernels are timed again at ViT-H/14
B=32 and at the L/16 SSL shapes (64 x 197 and 256 x 37 tokens), each under
``name[shape]``. Each time is the median over 7 windows of 20 launches
between one pair of CUDA events (this file's ``timing.py``, so both trees
are timed by the same code), each window one replay of a CUDA graph of the
20 launches, which holds the card's time alone (``ms``), and 20 launches
enqueued back to back, which holds the wrappers' host time where it exceeds
the card's (``ms_window``); a kernel whose op cannot be captured in a graph
(it synchronises) has its windowed time under ``ms`` too. It prints the
card's name and power limit and one JSON line ``{"card": ..., "root": ...,
"ms": {kernel: ms}, "ms_window": {kernel: ms}, "img_s": {model: img/s}}``
(a kernel with several cases sums their times; img/s of one B=64 forward
of the standard ViT-H/14 and of the hybrid's path B, P4's and P13's
models). To compare two commits, unpack the other one into a git-ignored
directory and run this file with ``--root`` on each in turns (parent,
change, change, parent) in one call. With ``--steps`` it times instead
P7's hybrid DeiT train step (hybrid ViT-H/14, B=32) and P10's hybrid DINOv2
step (hybrid ViT-L/16, B=32; ``--steps deit`` or ``--steps ssl`` one of
them), seeded random weights, as those phases time them (the host clock
around each synchronized step, median of 10 after 2 warm-up), and the host
microseconds to enqueue one ``linear_d8_fused`` at a small shape (M = 148,
c = 16, F = 24; K-lin-d8 is launched 64-96 times a step), and prints ``{"card": ..., "root": ..., "step_ms": {...},
"step_ms_all": {...}, "lin_host_us": ...}``: the steps' host time, which a
wrapper's host cost moves and a CUDA-graph replay hides. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch


def _timing():
    """This file's timing.py, whichever tree is timed."""
    spec = importlib.util.spec_from_file_location("_ovt_timing",
                                                  Path(__file__).with_name("timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_img_s(cs) -> dict:
    """img/s of one B=64 224^2 bf16 forward of the standard ViT-H/14 (P4)
    and of the hybrid's path B (P13: fused block epilogues, the LN kernel
    on), seeded random weights, ``chip_smoke.time_ms`` medians of 10."""
    from octic_vits_tpu_torch import create_model, init_weights
    from octic_vits_tpu_torch.layers import d8_layers

    images = torch.randn(cs.BATCH, cs.IMG, cs.IMG, 3,
                         generator=torch.Generator().manual_seed(cs.SEED + 1))
    images = images.to("cuda", torch.bfloat16)
    ips = {}
    for name, arch, flags, ln in (
            ("standard", "deit_huge_patch14_LS", {}, False),
            ("path B", "hybrid_deit_huge_patch14", {"fuse_block_epilogues": True}, True)):
        model = create_model(arch, device="cuda", dtype=torch.bfloat16, **flags).eval()
        init_weights(model, torch.Generator("cuda").manual_seed(cs.SEED))
        d8_layers.OCTIC_PALLAS_LN = ln
        with torch.no_grad():
            ms = cs.time_ms(lambda: model(images), iters=10, warmup=2)
        ips[name] = cs.BATCH / (ms / 1e3)
        del model
        torch.cuda.empty_cache()
    d8_layers.OCTIC_PALLAS_LN = False
    return ips


def lin_host_us(timing) -> float:
    """Host microseconds to enqueue one linear_d8_fused (bias, no epilogue)
    at M = 148, c = 16, F = 24, where the card keeps up."""
    from octic_vits_tpu_torch import ops

    g = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    xs = tuple(randn(148, 16) for _ in range(4)) + (randn(148, 64),)
    w1, we, bias = randn(4, 16, 24) * 0.25, randn(32, 48) * 0.18, randn(24) * 0.1
    with torch.no_grad():
        return timing.host_us_per_call(lambda: ops.linear_d8_fused(xs, w1, we, bias))


def step_ms(cs, which: str = "all") -> tuple:
    """(median ms, every step's ms) of P7's hybrid DeiT step and P10's hybrid
    SSL step (`which`: "deit", "ssl" or "all"), built and timed as
    chip_smoke.py builds and times them."""
    from octic_vits_tpu_torch import create_model, init_weights
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    med, every = {}, {}
    if which != "ssl":
        cfg = DeiTConfig()
        model = create_model("hybrid_deit_huge_patch14", remat=True,
                             drop_path_rate=cfg.drop_path, compute_dtype=torch.bfloat16,
                             device="cuda")
        init_weights(model, torch.Generator("cuda").manual_seed(cs.SEED))
        state, step = cs.train_setup(model, cfg)
        tgen = torch.Generator().manual_seed(cs.SEED + 3)
        images = torch.randn(cs.TRAIN_BATCH, cs.IMG, cs.IMG, 3, generator=tgen).cuda()
        labels = torch.randint(0, 1000, (cs.TRAIN_BATCH,), generator=tgen).cuda()
        med["deit_hybrid"], every["deit_hybrid"] = cs.time_train_steps(state, step, images,
                                                                       labels, tgen)
        del state, step, model
        torch.cuda.empty_cache()
    if which == "deit":
        return med, every
    arch = SSLMetaArch(SSLConfig(backbone_remat=True), device="cuda")
    state = arch.init(torch.Generator("cuda").manual_seed(cs.SEED))
    lr = sqrt_lr_scaling(4e-3, cs.SSL_BATCH)
    sched = dict(lr=lr, wd=0.04, last_layer_lr=lr, momentum=0.992, teacher_temp=0.04)
    batch = batch_to_device(cs.ssl_batch(cs.SSL_BATCH, cs.SEED + 5), "cuda")
    med["ssl_hybrid"], every["ssl_hybrid"] = cs.time_ssl_steps(
        state, arch.make_train_step(), batch, sched, torch.Generator().manual_seed(cs.SEED + 6))
    del state, arch
    torch.cuda.empty_cache()
    return med, every


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="root of the tree to time")
    parser.add_argument("--steps", nargs="?", const="all", choices=("all", "deit", "ssl"),
                        help="time P7's and/or P10's hybrid train steps instead of the kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    timing = _timing()
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_power()
    print(card, flush=True)
    if args.steps:
        med, every = step_ms(cs, args.steps)
        print(json.dumps({"card": card, "root": root, "step_ms": med, "step_ms_all": every,
                          "lin_host_us": lin_host_us(timing)}), flush=True)
        return 0
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    h14 = (cs.BATCH, 257, 1280, 16, True)
    sets = [(cs.p2_cases, h14), (cs.train_kernel_cases, (cs.TRAIN_BATCH,) + h14[1:])]
    for b64, b32 in (("glue_b64_cases", None), ("packed_b64_cases", "packed_b32_cases"),
                     ("wide_b64_cases", "wide_b32_cases"), (None, "ssl_kernel_cases")):
        if b64 and hasattr(cs, b64):
            sets.append((getattr(cs, b64), h14))
        if b32 and hasattr(cs, b32):
            sets.append((getattr(cs, b32), (cs.TRAIN_BATCH,) + h14[1:]))
    # P2's kernels again at the DeiT step's B=32 and the L/16 SSL crops
    # (global 64 x 197, local 256 x 37 tokens), each under "name[shape]"
    extra = (("h14_b32", (cs.TRAIN_BATCH,) + h14[1:]), ("l16_global", (64, 197, 1024, 16, True)),
             ("l16_local", (256, 37, 1024, 16, True)))
    times, windows = {}, {}

    def add(name, fn):
        win = timing.time_per_launch(fn)
        try:
            dev = timing.time_per_launch(fn, graph=True)
        except RuntimeError:  # the op synchronises: no graph of it
            torch.cuda.synchronize()
            dev = win
        times[name] = times.get(name, 0.0) + dev
        windows[name] = windows.get(name, 0.0) + win

    with torch.no_grad():
        for cases, shape in sets:
            for name, kern, _, args_, _, _ in cases(gen, *shape):
                add(name, lambda: kern(*args_))
        for label, shape in extra:
            for name, kern, _, args_, _, _ in cs.p2_cases(gen, *shape):
                add(f"{name}[{label}]", lambda: kern(*args_))
    print(json.dumps({"card": card, "root": root, "ms": times, "ms_window": windows,
                      "img_s": model_img_s(cs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
