"""BENCHMARK.json against the contract's static rules, and the discovery of
every cell's files by name."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import harness, work

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert len(MANIFEST["command"]) <= 32 and all(one_line(w) for w in MANIFEST["command"])
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_keys():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and one_line(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_setup_s_and_per_layer_moves():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS and cell in moved.get("workloads", CELLS)
    for cell in CELLS:
        spec = harness.find_cell(cell, MANIFEST)
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and spec.per_layer
    # one suffix, one end-to-end metric
    moves = {}
    for m in MANIFEST["per_layer"]:
        moves.setdefault(m["name"].split(".", 1)[1], set()).add(m["moves"])
    assert all(len(v) == 1 for v in moves.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.find_cell(cell, MANIFEST)
    entry = importlib.import_module(f"benchmark.entries.{spec.mix['entry']}")
    assert hasattr(entry, "Cell")
    importlib.import_module(f"benchmark.reference.{spec.config['reference']}")
    assert (BENCH / "weight_schemes" / f"{spec.config['weights']}.json").is_file()
    assert spec.limits, f"limits/{cell}.json is missing"
    for name, lim in spec.limits.items():
        assert lim["limit"] is not None and lim["limit"] > 0, name
    for m in spec.per_layer:
        reader = importlib.import_module(f"benchmark.metrics.{m['name'].split('.', 1)[0]}")
        assert callable(reader.read)


def test_config_files_hold_the_cells_configuration():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_op_files():
    ops = work.load_ops()
    assert ops
    env = work.shape_env(64, 257, 1280, 16, True)
    for name, spec in ops.items():
        assert spec["backward"] == spec["forward"] + "Backward", name
        for direction in ("fwd", "bwd"):
            nbytes, tc, f32 = work.work(spec, direction, env)
            assert nbytes > 0 and tc >= 0 and f32 >= 0
