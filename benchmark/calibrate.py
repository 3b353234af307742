"""The readings that a cell's limits are set from, on the card: the program's
compared numbers over many seeds, and over some of them the control's (the
plain reference computed with every product's operands rounded to float8,
the precision below the cell's bf16) and the planted faults' that the cell
can have. Prints one JSON line a seed and one summary line.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 5
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import octic_vit  # noqa: E402


def control_readings(cell) -> dict:
    """The control's and the faults' numbers, each against the f32 reference
    that the run's check computed."""
    if hasattr(cell, "reference_logits"):
        from benchmark.entries.infer import row_gaps

        ref = cell.ref_answers
        ctrl = cell.reference_logits(quant=octic_vit.fp8)
        name = f"{cell.mix.get('answer', 'logit')}_gap"
        return {"control": {name: max(float(row_gaps(c, r).max()) for c, r in zip(ctrl, ref))}}
    import inspect

    from benchmark.compare import train_gaps

    ref = cell.ref_readings
    out = {"control": train_gaps(cell.reference(quant=octic_vit.fp8), ref)}
    if "half_batch" in inspect.signature(cell.reference).parameters:
        out["half_batch"] = train_gaps(cell.reference(half_batch=True), ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    spec = harness.find_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: list = []
        t0 = time.perf_counter()
        res = harness.run_cell(spec, seed, args.seconds, False, "cuda", t0, keep=keep)
        row = {"seed": seed, "checks": {k: v["value"] for k, v in res["checks"].items()},
               "attempted": res["attempted"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30}
        t1 = time.perf_counter()
        cell = keep[0]
        if hasattr(cell, "ref_readings"):  # where the train gaps come from
            from benchmark.compare import worst_leaves

            row["worst"] = {k: worst_leaves(cell.readings[k], cell.ref_readings[k])
                            for k in ("grad", "change", "teacher_change", "ema_change")
                            if k in cell.readings}
        if seed in controls:
            row.update(control_readings(keep[0]))
        row["seconds"] = [t1 - t0, time.perf_counter() - t1]
        print(json.dumps(row), flush=True)
        rows.append(row)
        keep.clear()
        torch.cuda.empty_cache()
    summary = {}
    for key in rows[0]["checks"]:
        summary[key] = {"program_max": max(r["checks"][key] for r in rows),
                        "control_min": min((r["control"][key] for r in rows if "control" in r),
                                           default=None)}
        faults = [r["half_batch"][key] for r in rows if "half_batch" in r]
        if faults:
            summary[key]["half_batch_min"] = min(faults)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
