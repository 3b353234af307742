"""CUDA-event times of the attention kernels at the ViT-H/14 shapes of
``chip_smoke.py``, for comparing two trees on one card:

    python3 -m octic_vits_tpu_torch.tools.time_kernels

It times, in this tree, the forward kernels of P2 and the train-path kernels
of P5 (B=64 and B=32, with bias), and P18's wide-qkv kernels where this
tree's ``chip_smoke.py`` has them, each the median of 50 launches after
warm-up, and prints the card's name and power limit and one JSON line
``{"card": ..., "ms": {kernel: ms}}`` (a kernel with several cases sums
their times). To compare two commits, run it from the root of each checkout
in turns (parent, change, change, parent) in one call: each run builds its
own tree's kernels. Run from the repository root (it imports
``chip_smoke``); needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_power()
    print(card, flush=True)
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    h14 = (cs.BATCH, 257, 1280, 16, True)
    sets = [(cs.p2_cases, h14), (cs.train_kernel_cases, (cs.TRAIN_BATCH,) + h14[1:])]
    if hasattr(cs, "wide_b64_cases"):
        sets += [(cs.wide_b64_cases, h14), (cs.wide_b32_cases, (cs.TRAIN_BATCH,) + h14[1:])]
    times = {}
    with torch.no_grad():
        for cases, shape in sets:
            for name, kern, _, args, _, _ in cases(gen, *shape):
                times[name] = times.get(name, 0.0) + cs.time_ms(lambda: kern(*args), iters=50,
                                                                warmup=5)
    print(json.dumps({"card": card, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
