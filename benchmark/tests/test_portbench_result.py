"""The result line: exactly the contract's keys, the compared numbers last;
the command's refusals: no card, and a directory without the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("mix_name", ["infer_b64", "deit_b256"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(mix_name, trace):
    spec = tiny.spec(mix_name, {})
    res = harness.run_cell(spec, 123456789012, 0.2, trace, "cpu", time.perf_counter())
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == keys
    json.dumps(res)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for check in res["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(res["metrics"]) <= {m["name"] for m in spec.per_layer}
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0


def command(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "hybrid_vith14.infer_b64", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=env)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = command(tmp_path, env)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of the inference cell through the command, on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = command(ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks" and res["device"]["platform"] == "gpu"
