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
``name[shape]``. Each time is the median over 7 windows of 20
back-to-back launches between one pair of CUDA events (this file's
``timing.py``), so that the wrappers' host time, which ``chip_smoke.time_ms``
keeps in its windows, is spread over the launches and both trees are timed
by the same code. It prints the card's name and power limit and one JSON
line ``{"card": ..., "root": ..., "ms": {kernel: ms}, "img_s": {model: img/s}}``
(a kernel with several cases sums their times; img/s of one B=64 forward
of the standard ViT-H/14 and of the hybrid's path B, P4's and P13's
models). To compare two commits, unpack the other one into a git-ignored
directory and run this file with ``--root`` on each in turns (parent,
change, change, parent) in one call. Needs a CUDA device.
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="root of the tree to time")
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
    times = {}
    with torch.no_grad():
        for cases, shape in sets:
            for name, kern, _, args_, _, _ in cases(gen, *shape):
                times[name] = times.get(name, 0.0) + timing.time_per_launch(
                    lambda: kern(*args_))
        for label, shape in extra:
            for name, kern, _, args_, _, _ in cs.p2_cases(gen, *shape):
                times[f"{name}[{label}]"] = timing.time_per_launch(lambda: kern(*args_))
    print(json.dumps({"card": card, "root": root, "ms": times, "img_s": model_img_s(cs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
