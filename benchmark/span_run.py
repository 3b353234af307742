"""Run one cell once, as ``run.py --trace 1`` does, with a third traced
window in which the program's spans are on (``spans.py``), and print the
run's result line with the span metrics and ``breakdown.idle_gaps_by_span``.

    python3 benchmark/span_run.py --workload <config>.<mix> --seed <n> --seconds <s>

The span metrics are the entries of ``span_metrics.json`` (in the form of
``BENCHMARK.json``'s ``per_layer``) that list the cell; each is read by
``metrics/<base>.py`` from the window's spans. The line also carries
``span_coverage``: the share of the cell's host time of its calls that the
root spans cover, and of the window's kernels' device time launched inside
them; and ``span_window``: the window's kernels and busy seconds, and the
host ms a root in each span and in the runtime calls by name."""

import time

T_START = time.perf_counter()

import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness, spans  # noqa: E402

HERE = Path(__file__).resolve().parent


def span_metrics(cell: str) -> list:
    entries = json.loads((HERE / "span_metrics.json").read_text())["per_layer"]
    return [m for m in entries if cell in m["workloads"]]


def with_span_window(cls, device: torch.device, found: list):
    """The entry's cell, whose release first runs the window with the spans
    (after the run's traced windows, its readers and the peak memory)."""

    class SpanCell(cls):
        def release(self):
            found.append(spans.span_window(self, device))
            super().release()

    return SpanCell


def run_cell(spec: harness.CellSpec, seed: int, seconds: float, device, t_start: float,
             cell_factory=None) -> dict:
    """``harness.run_cell`` with ``trace`` and the window with the spans;
    `cell_factory` (tests) replaces the entry's ``Cell``."""
    device = torch.device(device)
    entry = importlib.import_module(f"benchmark.entries.{spec.mix['entry']}")
    found: list = []
    factory = with_span_window(cell_factory or entry.Cell, device, found)
    result = harness.run_cell(spec, seed, seconds, True, device, t_start, cell_factory=factory)
    ctx = types.SimpleNamespace(spans=found[0])
    for m in span_metrics(spec.name):
        value = harness.read_metric(m["name"], ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if found[0] is not None:
        result["breakdown"]["idle_gaps_by_span"] = spans.idle_gaps_by_span(found[0])
        result["span_coverage"] = spans.coverage(found[0])
        result["span_window"] = spans.window_info(found[0])
    return result


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s)", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
