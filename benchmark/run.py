"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program; needs as many CUDA
cards as the cell asks for. The last line of standard output is the result
as one JSON object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)  # the checkout's root, not this folder (its modules are package-local)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
