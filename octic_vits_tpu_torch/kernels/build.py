"""Build the CUDA sources in ``csrc/`` into one shared library and bind it.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
without PyTorch's headers. The library lands in
``<repo>/build/octic_vits_tpu_torch/<hash>/`` at first use, keyed by a hash
of the sources and flags, so a fresh checkout builds everything on its
first kernel call and an unchanged tree reuses the earlier build.

Nothing here runs at import: machines without ``nvcc`` (the CPU test lane)
import the ops modules and only ever call the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "octic_vits_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
LIB_NAME = "libocticvits_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "ovt_dense_gelu": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ovt_lin_d8": [_P] * 13 + [_I, _I, _I, _I, _P],
    "ovt_attention_std": [_P, _P, _I, _I, _I, _I, _P],
    "ovt_attention_octic": [_P] * 11 + [_I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the sources unless this hash is already built.

    Returns the library path and the seconds spent compiling (0 when reused).
    The library is written under a temporary name and renamed, so a build
    that is cut off never leaves a half-written library behind."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library with argtypes/restype set on every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ovt_error_string.argtypes = [ctypes.c_int]
    lib.ovt_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call entry point `name` on the current CUDA stream and raise if the
    launch was refused. Tensors are passed by data pointer (the caller keeps
    them alive across the call); Python ints as C ints."""
    lib = library()
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            cargs.append(ctypes.c_void_p(0))
        else:
            cargs.append(ctypes.c_int(int(a)))
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    err = getattr(lib, name)(*cargs)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.ovt_error_string(err).decode()})"
        )
