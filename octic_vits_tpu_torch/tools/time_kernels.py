"""CUDA-event times of the attention and linear kernels at the ViT-H/14 shapes
of ``chip_smoke.py``, for comparing two trees on one card:

    python3 octic_vits_tpu_torch/tools/time_kernels.py [--root DIR]

It times the tree at DIR (default: the current directory; it imports DIR's
``chip_smoke`` and ``octic_vits_tpu_torch``, so DIR's own kernels are built
and run): the forward kernels of P2 and the train-path kernels of P5 (B=64
and B=32, with bias), and P11's, P15's and P18's B=64 kernels (the fused
glue, the packed container, the wide qkv; their B=32 ones too, and
P8's fused qkv + attention backward at ViT-H/14 B=32) where that tree's
``chip_smoke.py`` has them: every kernel that runs K-attn-bwd is there (rows
1b, 2b, 5, 10, 12 and 13a). P2's four kernels are timed again at ViT-H/14
B=32 and at the L/16 SSL shapes (64 x 197 and 256 x 37 tokens), each under
``name[shape]``. K-lin-d8-bwd alone (the tail of rows 2b and 10b) is timed
at the L/16 global and local crops and on the packed container at H/14
B=32 under ``lin_d8_bwd[shape]``, cuBLAS doing the same products beside it
under ``lin_d8_bwd_cublas[shape]``, and the host microseconds to enqueue one
of its calls under ``host_us``. K-ln-d8's affine backward (row 8) is timed
alone at H/14 B=32, the L/16 global crop and the ragged shape under
``ln_bwd[shape]``. ``--only TEXT`` times only the kernels whose name holds
TEXT (no img/s), for trial trees that differ in one kernel. Each time is the
median over 7 windows of 20 launches between one pair of CUDA events (this
file's ``timing.py``, so both trees are timed by the same code), each window
one replay of a CUDA graph of the 20 launches, which holds the card's time
alone (``ms``), and 20 launches
enqueued back to back, which holds the wrappers' host time where it exceeds
the card's (``ms_window``); a kernel whose op cannot be captured in a graph
(it synchronises) has its windowed time under ``ms`` too. It prints the
card's name and power limit and one JSON line ``{"card": ..., "root": ...,
"ms": {kernel: ms}, "ms_window": {kernel: ms}, "host_us": {kernel: µs},
"img_s": {model: img/s}}``
(a kernel with several cases sums their times; img/s of one B=64 forward
of the standard ViT-H/14 and of the hybrid's path B, P4's and P13's
models). To compare two commits, unpack the other one into a git-ignored
directory and run this file with ``--root`` on each in turns (parent,
change, change, parent) in one call. With ``--steps`` it times instead
P7's hybrid DeiT train step (hybrid ViT-H/14, B=32), P14's path-C DeiT step
(plain octic linears, the D8-GELU and LN kernels: the 32 launches of the
LN's affine backward a step run here), P17's packed inv-early DeiT step
(B=32) and P10's hybrid DINOv2 step (hybrid ViT-L/16, B=32; ``--steps
deit``, ``path_c``, ``packed`` or ``ssl`` one of them), seeded random
weights, as those phases time them (the host clock
around each synchronized step, median of 10 after 2 warm-up), and the host
microseconds to enqueue one ``linear_d8_fused`` at a small shape (M = 148,
c = 16, F = 24; K-lin-d8 is launched 64-96 times a step), and prints ``{"card": ..., "root": ..., "step_ms": {...},
"step_ms_all": {...}, "lin_host_us": ..., "ln_bwd_views": ...}``
(``ln_bwd_views``: in one path-C step, the LN backwards whose cotangents
arrived as non-contiguous views, which the op copies, and the backwards in
all): the steps' host time, which a
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


def lin_d8_bwd_cublas(xs, w1, we, dq, de):
    """The products of K-lin-d8-bwd as cuBLAS calls, a yardstick timed beside
    the kernel and never on the op's path: the operands stacked once
    (untimed), then the four 1-d dx products as one bmm, the two E rows' as
    one matmul, the four dw1 products as one bmm, dwe as one matmul over both
    rows' tokens, and the dbias sum. Returns the callable."""
    c = w1.shape[1]
    dq4 = torch.stack([t.reshape(-1, t.shape[-1]) for t in dq])
    de2 = torch.stack([t.reshape(-1, t.shape[-1]) for t in de])
    x4 = torch.stack([t.reshape(-1, c) for t in xs[:4]])
    ef = xs[4].reshape(-1, 4 * c)
    rows, dec = torch.cat([ef[:, :2 * c], ef[:, 2 * c:]]), torch.cat(list(de2))
    w1t, wet = w1.transpose(1, 2), we.t()

    def run():
        return (torch.bmm(dq4, w1t), torch.matmul(de2, wet), torch.bmm(x4.transpose(1, 2), dq4),
                torch.mm(rows.t(), dec), dq4[0].sum(0))
    return run


# K-lin-d8-bwd alone (the tail of rows 2b and 10b): the L/16 global and local
# crops, and the packed container at H/14 B=32 (row 10b), as (b, n, c, packed)
LIN_BWD_SHAPES = (("l16_global", 64, 197, 1024, False), ("l16_local", 256, 37, 1024, False),
                  ("h14_b32_packed", 32, 257, 1280, True))


def lin_d8_bwd_cases(seed: int = 0) -> list:
    """(label, the tree's K-lin-d8-bwd launch, cuBLAS's products) at each of
    LIN_BWD_SHAPES with bias, seeded random bf16 operands; on the packed shape
    the inputs are the slot views of one container and dx lands in the views
    of another. Both trees of an A/B take the same launch signature."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f
    from octic_vits_tpu_torch.ops import linear as Lin

    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    cases = []
    for label, b, n, c, packed in LIN_BWD_SHAPES:
        c8 = c // 8
        if packed:
            xs, out = unpack_packed_5f(randn(b, n, c)), unpack_packed_5f(randn(b, n, c))
        else:
            xs, out = tuple(randn(b, n, c8) for _ in range(4)) + (randn(b, n, 4 * c8),), None
        w1, we = randn(4, c8, 3 * c8, scale=c8 ** -0.5), randn(2 * c8, 6 * c8,
                                                             scale=(2 * c8) ** -0.5)
        dq = tuple(randn(b, n, 3 * c8) for _ in range(4))
        de = tuple(randn(b, n, 6 * c8) for _ in range(2))
        cases.append((label, lambda xs=xs, w1=w1, we=we, dq=dq, de=de, out=out:
                      Lin.lin_d8_bwd_launch(xs, w1, we, dq, de, True, out=out),
                      lin_d8_bwd_cublas(xs, w1, we, dq, de)))
    return cases


# K-ln-d8's affine backward alone (row 8): the path-C DeiT step's H/14 B=32,
# the L/16 global crop and P11's ragged shape, as (b, n, c8)
LN_BWD_SHAPES = (("h14_b32", 32, 257, 160), ("l16_global", 64, 197, 128), ("ragged", 3, 65, 8))


def ln_bwd_cases(seed: int = 0) -> list:
    """(label, one call of the tree's ``ops.ln_affine_d8_bwd``) at each of
    LN_BWD_SHAPES: seeded bf16 input and cotangent, f32 scales near 1 (the
    train step's parameters). Both trees of an A/B take the same call."""
    from octic_vits_tpu_torch import ops

    g = torch.Generator("cuda").manual_seed(seed)

    def five(b, n, c8):
        return tuple(torch.randn(b, n, w, generator=g, device="cuda").to(torch.bfloat16)
                     for w in (c8,) * 4 + (4 * c8,))

    cases = []
    for label, b, n, c8 in LN_BWD_SHAPES:
        xs, us = five(b, n, c8), five(b, n, c8)
        al = 1.0 + 0.2 * torch.randn(4, c8, generator=g, device="cuda")
        ae = 1.0 + 0.2 * torch.randn(1, 4 * c8, generator=g, device="cuda")
        cases.append((label, lambda xs=xs, us=us, al=al, ae=ae:
                      ops.ln_affine_d8_bwd(xs, al, ae, us)))
    return cases


def ln_bwd_views(cs, model, cfg, images, labels, gen) -> tuple:
    """(LN backwards whose cotangents came as non-contiguous views, LN
    backwards in all) over one train step of `model`: each such view costs
    the op a copy (``u.contiguous()``) before its kernel."""
    from octic_vits_tpu_torch.ops import ln_d8

    seen = []
    inner = ln_d8._LnAffine.backward

    def backward(ctx, *us):
        seen.append(any(not u.is_contiguous() for u in us))
        return inner(ctx, *us)

    state, step = cs.train_setup(model, cfg)
    ln_d8._LnAffine.backward = staticmethod(backward)
    try:
        step(state, images, labels, gen)
        torch.cuda.synchronize()
    finally:
        ln_d8._LnAffine.backward = staticmethod(inner)
    return sum(seen), len(seen)


def step_ms(cs, which: str = "all") -> tuple:
    """(median ms, every step's ms, path C's ``ln_bwd_views``) of P7's
    hybrid DeiT step, P14's path-C step (the LN kernel on), P17's packed
    inv-early DeiT step (``packed_carry``, ``fuse_qkv``, ``fuse_mlp``: row
    10b's chain runs in it) and P10's hybrid SSL step (`which`: "deit",
    "path_c", "packed", "ssl" or "all"), built and timed as chip_smoke.py
    builds and times them (P14's and P17's at 10 steps after 2 warm-up, as
    P7's)."""
    from octic_vits_tpu_torch import create_model, init_weights
    from octic_vits_tpu_torch.layers import d8_layers
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    med, every, views = {}, {}, None
    deit = {"deit": ("deit_hybrid", "hybrid_deit_huge_patch14", {}),
            "path_c": ("deit_path_c", "hybrid_deit_huge_patch14",
                       dict(use_pallas_linear=False, use_pallas_gelu=True)),
            "packed": ("deit_inv_packed", "d8_inv_early_deit_huge_patch14",
                       dict(packed_carry=True, fuse_qkv=True, fuse_mlp=True))}
    for key in ("deit", "path_c", "packed"):
        if which not in ("all", key):
            continue
        label, arch, flags = deit[key]
        cfg = DeiTConfig()
        model = create_model(arch, remat=True, drop_path_rate=cfg.drop_path,
                             compute_dtype=torch.bfloat16, device="cuda", **flags)
        init_weights(model, torch.Generator("cuda").manual_seed(cs.SEED))
        d8_layers.OCTIC_PALLAS_LN = key == "path_c"
        tgen = torch.Generator().manual_seed(cs.SEED + 3)
        images = torch.randn(cs.TRAIN_BATCH, cs.IMG, cs.IMG, 3, generator=tgen).cuda()
        labels = torch.randint(0, 1000, (cs.TRAIN_BATCH,), generator=tgen).cuda()
        if key == "path_c":
            views = ln_bwd_views(cs, model, cfg, images, labels, tgen)
        state, step = cs.train_setup(model, cfg)
        med[label], every[label] = cs.time_train_steps(state, step, images, labels, tgen)
        d8_layers.OCTIC_PALLAS_LN = False
        del state, step, model
        torch.cuda.empty_cache()
    if which not in ("all", "ssl"):
        return med, every, views
    arch = SSLMetaArch(SSLConfig(backbone_remat=True), device="cuda")
    state = arch.init(torch.Generator("cuda").manual_seed(cs.SEED))
    lr = sqrt_lr_scaling(4e-3, cs.SSL_BATCH)
    sched = dict(lr=lr, wd=0.04, last_layer_lr=lr, momentum=0.992, teacher_temp=0.04)
    batch = batch_to_device(cs.ssl_batch(cs.SSL_BATCH, cs.SEED + 5), "cuda")
    med["ssl_hybrid"], every["ssl_hybrid"] = cs.time_ssl_steps(
        state, arch.make_train_step(), batch, sched, torch.Generator().manual_seed(cs.SEED + 6))
    del state, arch
    torch.cuda.empty_cache()
    return med, every, views


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="root of the tree to time")
    parser.add_argument("--steps", nargs="?", const="all",
                        choices=("all", "deit", "path_c", "packed", "ssl"),
                        help="time P7's, P14's path-C, P17's packed and/or P10's train steps "
                             "instead of the kernels")
    parser.add_argument("--only", default=None,
                        help="time only the kernels whose name holds this text")
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
        med, every, views = step_ms(cs, args.steps)
        print(json.dumps({"card": card, "root": root, "step_ms": med, "step_ms_all": every,
                          "lin_host_us": lin_host_us(timing), "ln_bwd_views": views}),
              flush=True)
        return 0
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    h14 = (cs.BATCH, 257, 1280, 16, True)
    sets = [(cs.p2_cases, h14), (cs.train_kernel_cases, (cs.TRAIN_BATCH,) + h14[1:])]
    for b64, b32 in (("glue_b64_cases", "glue_b32_cases"),
                     ("packed_b64_cases", "packed_b32_cases"),
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
        if args.only is not None and args.only not in name:
            return
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
        host = {}
        for label, kern, cublas in lin_d8_bwd_cases(cs.SEED):
            add(f"lin_d8_bwd[{label}]", kern)
            add(f"lin_d8_bwd_cublas[{label}]", cublas)
            if args.only is None or args.only in f"lin_d8_bwd[{label}]":
                host[f"lin_d8_bwd[{label}]"] = timing.host_us_per_call(kern)
        for label, kern in ln_bwd_cases(cs.SEED):
            add(f"ln_bwd[{label}]", kern)
    img_s = model_img_s(cs) if args.only is None else {}
    print(json.dumps({"card": card, "root": root, "ms": times, "ms_window": windows,
                      "host_us": host, "img_s": img_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
