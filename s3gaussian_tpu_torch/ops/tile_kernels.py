"""The forward tile compositor: CUDA kernel ``csrc/composite_fwd.cu`` and
its wrapper (port of ``s3gaussian_tpu/ops/tile_kernels.py::composite_fwd_pallas``).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, keyed by a hash of its source,
under ``build/s3gaussian_tpu_torch/`` beside the package, and loaded with
``ctypes``.  A CUDA tensor launches the kernel or raises; only a CPU
tensor takes the plain version, ``composite.composite_tiles_torch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from s3gaussian_tpu_torch.ops.composite import (N_OUT_ROWS, PAIR_FEAT_DIM,
                                                composite_tiles_torch)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "composite_fwd.cu"
BUILD_DIR = _PKG.parent / "build" / "s3gaussian_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches made by composite_fwd (the CPU path does not count)
launches = 0
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the CUDA compositor cannot be built")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"composite_fwd_{digest[:16]}.so"


def build() -> str:
    """Compile the kernel unless a library for this source exists.
    Returns nvcc's output (registers, shared memory, spills per kernel),
    or "" when the library was already built."""
    so = library_path()
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.composite_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.composite_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def composite_fwd(pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                  grid_x: int, grid_y: int, tile_x: int,
                  tile_y: int) -> torch.Tensor:
    """pair_feat [16, M] float32 (feature-major sorted pair stream),
    tile_starts [T+1] int32 -> [T, 8, P] float32."""
    n_tiles = grid_x * grid_y
    p = tile_x * tile_y
    if pair_feat.dim() != 2 or pair_feat.shape[0] != PAIR_FEAT_DIM:
        raise ValueError(f"pair_feat must be [{PAIR_FEAT_DIM}, M], got "
                         f"{tuple(pair_feat.shape)}")
    if tile_starts.shape != (n_tiles + 1,):
        raise ValueError(f"tile_starts must be [{n_tiles + 1}], got "
                         f"{tuple(tile_starts.shape)}")
    if pair_feat.device != tile_starts.device:
        raise ValueError("pair_feat and tile_starts on different devices")
    if pair_feat.device.type == "cpu":
        return composite_tiles_torch(pair_feat, tile_starts, grid_x, grid_y,
                                     tile_x, tile_y)
    if pair_feat.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on CPU or CUDA tensors, not "
                         f"{pair_feat.device}")
    if pair_feat.dtype != torch.float32 or tile_starts.dtype != torch.int32:
        raise TypeError(f"composite_fwd takes float32 pair_feat and int32 "
                        f"tile_starts, got {pair_feat.dtype} and "
                        f"{tile_starts.dtype}")
    if not (pair_feat.is_contiguous() and tile_starts.is_contiguous()):
        raise ValueError("composite_fwd takes contiguous tensors")
    if not 0 < p <= 1024:
        raise ValueError(f"tile of {p} pixels: the kernel runs one thread "
                         f"per pixel, at most 1024")
    out = torch.empty(n_tiles, N_OUT_ROWS, p, dtype=torch.float32,
                      device=pair_feat.device)
    lib = _load()
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_fwd(pair_feat.data_ptr(), pair_feat.shape[1],
                                tile_starts.data_ptr(), out.data_ptr(),
                                grid_x, grid_y, tile_x, tile_y, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
