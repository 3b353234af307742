"""ctypes bindings for the native host-data kernels (the repository's
native/octic_data.cc; the port's own copy of octic_vits_tpu/data/native.py).

This is a host library, not a device kernel: it normalizes, rotates, crops,
resizes and jitters uint8 images on the CPU with OpenMP. The library is found
from this file's path (`<repo>/native/libocticdata.so`) and built there with
`make` on first use when it is missing and a compiler is present. Every entry
point has a numpy fallback, so the package works without the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from octic_vits_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libocticdata.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.normalize_batch_u8.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, f32p, f32p, ctypes.c_int]
    lib.normalize_batch_u8.restype = None
    lib.rot90_flip_batch_f32.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.rot90_flip_batch_f32.restype = None
    if hasattr(lib, "resize_crop_u8"):
        lib.resize_crop_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_float, ctypes.c_float, u8p,
                                       ctypes.c_int64, ctypes.c_int64]
        lib.resize_crop_u8.restype = None
        lib.color_jitter_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.color_jitter_u8.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def normalize_batch(images_u8: np.ndarray, mean: np.ndarray = IMAGENET_MEAN,
                    std: np.ndarray = IMAGENET_STD, nthreads: int = 0) -> np.ndarray:
    """[N,H,W,3] uint8 -> normalized float32 (native fast path)."""
    if images_u8.dtype != np.uint8 or images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected [N, H, W, 3] uint8, got {images_u8.dtype} "
                         f"{images_u8.shape}")
    lib = _load()
    if lib is None:
        return (images_u8.astype(np.float32) / 255.0 - mean) / std
    images_u8 = np.ascontiguousarray(images_u8)
    n, h, w, _ = images_u8.shape
    out = np.empty((n, h, w, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.normalize_batch_u8(
        images_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
    return out


def rot90_flip_batch(images: np.ndarray, k: int = 0, flip: bool = False,
                     nthreads: int = 0) -> np.ndarray:
    """NHWC float32 batch rot90^k (CCW) + optional hflip (square images)."""
    if images.ndim != 4 or images.dtype != np.float32 or images.shape[1] != images.shape[2]:
        raise ValueError(f"expected square [N, H, W, C] float32, got {images.dtype} "
                         f"{images.shape}")
    n, h, w, c = images.shape
    lib = _load()
    if lib is None:
        out = np.rot90(images, k=k, axes=(1, 2))
        if flip:
            out = out[:, :, ::-1]
        return np.ascontiguousarray(out)
    images = np.ascontiguousarray(images)
    out = np.empty_like(images)
    lib.rot90_flip_batch_f32(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, c, int(k), int(bool(flip)), nthreads)
    return out


def has_resize() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "resize_crop_u8")


def resize_crop(img_u8: np.ndarray, box, out_hw) -> Optional[np.ndarray]:
    """Crop `box` = (y0, x0, y1, x1) floats of an [H,W,3] uint8 image and
    resize to `out_hw` with the PIL-equivalent adaptive-support bicubic
    filter (antialiased downscale). Returns None when the native library
    is unavailable (the caller falls back to PIL)."""
    lib = _load()
    if lib is None or not hasattr(lib, "resize_crop_u8"):
        return None
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or img_u8.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img_u8.dtype} {img_u8.shape}")
    img_u8 = np.ascontiguousarray(img_u8)
    ih, iw, _ = img_u8.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.uint8)
    y0, x0, y1, x1 = (float(v) for v in box)
    lib.resize_crop_u8(img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ih, iw,
                       y0, x0, y1, x1, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       oh, ow)
    return out


def color_jitter_inplace(img_u8: np.ndarray, ops, factors) -> bool:
    """Sequential ColorJitter ops on an [H,W,3] uint8 image, in place.
    ops: list of codes (0 brightness, 1 contrast, 2 saturation, 3 hue);
    factors: matching floats (enhance factor, or hue shift in [-.5, .5]).
    Returns False when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "color_jitter_u8"):
        return False
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or not img_u8.flags.c_contiguous:
        raise ValueError("expected a C-contiguous [H, W, 3] uint8 image")
    if len(ops) != len(factors):
        raise ValueError(f"{len(ops)} ops against {len(factors)} factors")
    h, w, _ = img_u8.shape
    n = len(ops)
    ops_arr = (ctypes.c_int * n)(*ops)
    fac_arr = (ctypes.c_float * n)(*[float(f) for f in factors])
    lib.color_jitter_u8(img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                        ops_arr, fac_arr, n)
    return True
