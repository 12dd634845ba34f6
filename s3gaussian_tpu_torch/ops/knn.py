"""Mean squared 3-nearest-neighbour distance for Gaussian size init (port of
``s3gaussian_tpu/ops/knn.py``).

Above 4,096 points it calls ``knn_mean_dist2`` of the multithreaded C++
library ``native/libs3g_native.so`` (built from ``native/s3g_native.cpp``
beside the packages, with ``make -C native``) through its own small
``ctypes`` loader; otherwise, or when that library cannot be built, the
numpy Morton-window search below.  Init-only host code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when it cannot be."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _NATIVE_DIR / "libs3g_native.so"
    if not path.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.knn_mean_dist2.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, f32p, ctypes.c_int]
    _lib = lib
    return lib


def _native_knn(points: np.ndarray, k: int, window: int
                ) -> Optional[np.ndarray]:
    lib = _native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.knn_mean_dist2(pts.ctypes.data_as(f32p), len(pts), k, window,
                       out.ctypes.data_as(f32p), min(os.cpu_count() or 1, 16))
    return out


def _morton30(p: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from normalized [0,1)^3 coordinates."""
    q = np.clip((p * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def mean_knn_dist2(points: np.ndarray, k: int = 3,
                   window: int = 32) -> np.ndarray:
    """Per-point mean squared distance of the k nearest neighbours
    (approximate: ±window search in Morton order)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n > 4096:
        res = _native_knn(points, k, window)
        if res is not None:
            return res
    if n <= k:
        d = np.linalg.norm(points[:, None] - points[None], axis=-1) ** 2
        np.fill_diagonal(d, np.inf)
        d.sort(axis=1)
        return d[:, :max(1, n - 1)].mean(axis=1)

    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-9)
    order = np.argsort(_morton30((points - lo) / span), kind="stable")
    sorted_pts = points[order]

    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    idx = np.clip(np.arange(n)[:, None] + offs[None, :], 0, n - 1)
    diff = sorted_pts[idx] - sorted_pts[:, None, :]
    d2 = np.einsum("nwc,nwc->nw", diff, diff)
    d2[idx == np.arange(n)[:, None]] = np.inf   # self-hits from clipping
    d2.sort(axis=1)

    out = np.empty(n, dtype=np.float32)
    out[order] = d2[:, :k].mean(axis=1)
    return out
