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
1b, 2b, 5, 10, 12 and 13a). Each time is the median over 7 windows of 20
back-to-back launches between one pair of CUDA events (this file's
``timing.py``), so that the wrappers' host time, which ``chip_smoke.time_ms``
keeps in its windows, is spread over the launches and both trees are timed
by the same code. It prints the card's name and power limit and one JSON
line ``{"card": ..., "root": ..., "ms": {kernel: ms}}`` (a kernel with several
cases sums their times). To compare two commits, unpack the other one into a
git-ignored directory and run this file with ``--root`` on each in turns
(parent, change, change, parent) in one call. Needs a CUDA device.
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
    times = {}
    with torch.no_grad():
        for cases, shape in sets:
            for name, kern, _, args_, _, _ in cases(gen, *shape):
                times[name] = times.get(name, 0.0) + timing.time_per_launch(
                    lambda: kern(*args_))
    print(json.dumps({"card": card, "root": root, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
