"""Build the CUDA sources in ``csrc/`` into one shared library and bind it.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
without PyTorch's headers; each ``.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into the library. The library lands in
``<repo>/build/octic_vits_tpu_torch/<hash>/`` at first use, keyed by a hash
of the sources and flags, so a fresh checkout builds everything on its
first kernel call and an unchanged tree reuses the earlier build.

Nothing here runs at import: machines without ``nvcc`` (the CPU test lane)
import the ops modules and only ever call the plain versions.
"""

from __future__ import annotations

import array
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
    "-Xcompiler", "-fPIC", "-lineinfo",
)
LIB_NAME = "libocticvits_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "ovt_dense_gelu": [_P] * 4 + [_I] * 6 + [_P],
    "ovt_lin_d8": [_P] * 21 + [_I] * 14 + [_P],
    "ovt_lin_d8_sync": [_P] * 21 + [_I] * 12 + [_P],
    "ovt_attention_std": [_P] * 2 + [_I] * 11 + [_P],
    "ovt_attention_std_octic": [_P] * 7 + [_I] * 12 + [_P],
    "ovt_attention_octic_pieces": [_P] * 6 + [_I] * 6 + [_P] * 6 + [_I] * 8 + [_P],
    "ovt_attention_wide1d_pieces": [_P] * 5 + [_I] * 5 + [_P] * 6 + [_I] * 8 + [_P],
    "ovt_attention_octic_rows": [_P] * 6 + [_I] * 6 + [_P] * 6 + [_I] * 5 + [_P],
    "ovt_attention_bwd": [_P, _P],
    "ovt_attention_bwd_pack": [_P, _P],
    "ovt_attention_std_bwd_sync": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ovt_attention_octic_bwd_sync": ([_P] * 6 + [_I] * 6) * 2 + [_P] * 8 + [_I] * 6 + [_P],
    "ovt_lin_d8_bwd": [_P] * 22 + [_I] * 8 + [_P],
    "ovt_ln_d8_fwd": [_P] * 14 + [_I] * 4 + [_F, _P],
    "ovt_ln_d8_bwd": [_P] * 20 + [_I] * 5 + [_F, _P],
    "ovt_gelu_d8": [_P] * 15 + [_I] * 3 + [_P],
    "ovt_attention_probe": [_P] * 3 + [_I] * 3 + [_P] * 7 + [_I] * 12 + [_P],
    "ovt_attention_headmajor_bwd": [_P] * 5 + [_I] * 4 + [_P],
    "ovt_attention_probe_octic": [_P] * 6 + [_I] * 6 + [_P] * 6 + [_I] * 7 + [_P],
    "ovt_hoist_octic": [_P] * 6 + [_I] * 6 + [_P] + [_I] * 6 + [_P],
    "ovt_lin_d8_tiled": [_P] * 14 + [_I] * 13 + [_P],
    "ovt_mma_law": [_P] * 3 + [_I] * 7 + [_P],
    "ovt_attention_octic_bwd_widestore": ([_P] * 6 + [_I] * 6) * 2 + [_P] * 3 + [_I] * 5 + [_P],
    "ovt_attention_octic_bwd_wideg": [_P] * 6 + [_I] * 6 + [_P, _I] + [_P] * 8 + [_I] * 5
                                     + [_P],
    "ovt_attention_group_std": [_P] * 2 + [_I] * 6 + [_P],
    "ovt_attention_group_std_bwd": [_P] * 5 + [_I] * 6 + [_P],
    "ovt_attention_group_octic": [_P] * 12 + [_I] * 8 + [_P],
    "ovt_attention_group_octic_bwd": [_P] * 20 + [_I] * 8 + [_P],
    "ovt_qkv_attention": [_P] * 14 + [_I] * 4 + [_P],
    "ovt_qkv_attention_proj": [_P] * 16 + [_I] * 4 + [_P],
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
    tag = f"{os.getpid()}.tmp"
    nvcc = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
    if verbose:
        nvcc.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([*nvcc, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    logs = []
    try:
        for src, proc in zip(sorted(CSRC.glob("*.cu")), procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                                   f"{err[-8000:]}")
            logs.append(err)
    finally:
        for proc in procs:  # a failed or cut-off build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    proc = subprocess.run([*nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    if verbose:
        print("".join(logs) + proc.stderr)
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
    launch was refused. Tensors and host arrays (``array.array``, a launch
    table) are passed by data pointer (the caller keeps them alive across the
    call); Python ints as C ints, floats as C floats."""
    lib = library()
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        elif isinstance(a, array.array):
            cargs.append(ctypes.c_void_p(a.buffer_info()[0]))
        elif a is None:
            cargs.append(ctypes.c_void_p(0))
        elif isinstance(a, float):
            cargs.append(ctypes.c_float(a))
        else:
            cargs.append(ctypes.c_int(int(a)))
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    err = getattr(lib, name)(*cargs)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.ovt_error_string(err).decode()})"
        )
