"""H100 probes of the kernels' time, after the TPU scripts of the same names
(``scripts/profile_attn_kernel.py``, ``r3_attn_ablate.py``, ``r3_attn_bh.py``,
``r3_attn_headmajor.py``, ``r3_attn_experiments.py``, ``profile_lin_tiles.py``,
``r3_matmul_law.py``, ``r3_attn_bwd_ablate.py``). Each module's ``main()``
runs on the card from the repository root (it imports ``chip_smoke`` for the
card's name, the inputs and the bounds), e.g.

    python3 -m octic_vits_tpu_torch.probes.r3_attn_ablate

checks each variant against its plain version, then times the variants in
turns (``tools/timing.py``) and prints the card's name and power limit, each
time, its ratio to the first case and its bound, and the split of the
kernel's time that the differences give. The kernels are the ops of
``ops/attention_probe.py``, ``ops/linear_probe.py``, ``ops/mma_probe.py`` and
``ops/attention_bwd_probe.py``."""

from __future__ import annotations

import json
import sys

import torch


def card_or_exit(name: str):
    """The chip_smoke module and the card's nvidia-smi line, or exit 2 where
    there is no CUDA device."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; the probes run only on a GPU", file=sys.stderr)
        sys.exit(2)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.gpu_name_and_power()
    print(card, flush=True)
    return chip_smoke, card


def check(cs, label: str, out, ref, scaled: bool = False, cols=None, tol=None) -> None:
    """Hold a kernel's output against its plain version with chip_smoke's
    bars (`tol` = (atol, rtol) in place of the forward bar, where given; on
    the columns `cols` of the last dim only, where given); raise outside
    them."""
    if cols is not None:
        out, ref = out[..., cols], ref[..., cols]
    err, ok = cs.compare(out, ref, scaled, tol or (cs.ATOL, cs.RTOL))
    print(f"check {label}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel outside its bar")


def report(card: str, res: dict, bounds: dict, split: dict) -> None:
    """Print each case's times in turns, its ratio to the first case and its
    bound, then the split, then one JSON line of the medians and the split."""
    print(f"in turns on {card} (ms per launch, {len(next(iter(res['ms'].values())))} turns):")
    for name, times in res["ms"].items():
        b = bounds.get(name)
        bound = f", bound {b[0]:.4f} ms ({b[1]})" if b else ""
        print(f"  {name:34s} {' / '.join(f'{t:.4f}' for t in times)} | median "
              f"{res['median'][name]:.4f} | x{res['ratio'][name]:.3f}{bound}", flush=True)
    for name, ms in split.items():
        print(f"  {name:34s} {ms:9.4f} ms", flush=True)
    print(json.dumps({"card": card, "median_ms": res["median"], "ratio": res["ratio"],
                      "split_ms": split,
                      "bound_ms": {k: v[0] for k, v in bounds.items()}}), flush=True)
