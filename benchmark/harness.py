"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the check of what the window produced against the plain
reference, and the result line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` is found by name: its
configuration in ``configs/<config>.json``, its traffic in
``mixes/<mix>.json``, whose ``entry`` names the module of ``entries/`` that
drives the program, and its limits in ``limits/<cell>.json``. A per-layer
metric ``<base>.<suffix>`` is read by ``metrics/<base>.py``; the op layer is
the set of ``ops/*.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import trace as T
from benchmark import work
from benchmark.window import Window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "octic_vits_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, manifest: Optional[dict] = None) -> CellSpec:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}

    def here(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if here(m) and m["moves"] in e2e_names]
    return CellSpec(name, int(cell["chips"]), config, mix, limits, e2e, layer)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""

    spec: CellSpec
    window: Window           # the untraced window of this run
    images_per_step: int
    trace: T.Trace           # a traced window of the device's activity alone
    trace_images: int
    shaped: T.Trace          # a traced window with the host's ops and their shapes
    shaped_images: int
    peak_bytes: int
    ops: Dict[str, dict]
    flops_per_image: float
    _layer: Optional[dict] = None

    def op_layer(self) -> dict:
        """The op layer of the window with shapes (its calls need them)."""
        if self._layer is None:
            self._layer = T.op_layer(self.shaped, self.ops)
        return self._layer

    def shape_env(self, b: int, n: int) -> dict:
        """The variables of the op files' formulas at a call of `b` images of
        `n` tokens."""
        c = self.spec.config
        return work.shape_env(b, n, c["embed_dim"], c["num_heads"], c.get("qkv_bias", True))


def read_metric(name: str, ctx: Context) -> Optional[float]:
    reader = importlib.import_module(f"benchmark.metrics.{name.split('.', 1)[0]}")
    return reader.read(ctx)


def traced(cell, device: torch.device, host: bool) -> tuple:
    """(trace, images) of one traced window of the cell. With `host` the
    profiler records the host's ops and their input shapes, which ties each
    kernel to its op but slows the host's dispatch; without it only the
    device's activity, so the host runs near its untraced pace and the
    device's busy and idle time are read from that window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts, record_shapes=host) as prof:
        t0 = time.perf_counter()
        images = cell.trace_window()
        sync()
        wall = time.perf_counter() - t0
    return T.from_kineto(prof.profiler.kineto_results.events(), wall), images


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, device, t_start: float,
             cell_factory=None, keep: Optional[list] = None) -> dict:
    """Run the cell once and return the result line's object. `cell_factory`
    (tests) replaces the entry's ``Cell``; the cell object is appended to
    `keep` where given (its inputs stay for the calibration's control)."""
    device = torch.device(device)
    entry = importlib.import_module(f"benchmark.entries.{spec.mix['entry']}")
    cell = (cell_factory or entry.Cell)(spec.config, spec.mix, seed, device)
    if keep is not None:
        keep.append(cell)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    win = cell.window(seconds)
    dev = device_info(device, spec.chips)
    result: dict = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": dev}
    if trace:
        tr, images = traced(cell, device, host=False)
        shaped, shaped_images = traced(cell, device, host=True)
        dev["memory_peak_bytes"] = device_info(device, spec.chips)["memory_peak_bytes"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.wall_s
        ctx = Context(spec, win, cell.images_per_step, tr, images, shaped, shaped_images,
                      dev["memory_peak_bytes"], work.load_ops(), cell.flops_per_image())
        for m in spec.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = T.breakdown(tr, shaped)
    else:
        values = cell.end_to_end(win)
        values["setup_s"] = setup_s
        for m in spec.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    cell.release()
    checks, attempted, failed = cell.check(spec.limits)
    result["attempted"], result["failed"] = attempted, failed
    result["correct"] = failed == 0 and bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv: List[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check failed_answers {result['failed']} of {result['attempted']} limit 0",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
