"""The tile compositor's CUDA kernels, their wrappers and the autograd
function around them (port of ``s3gaussian_tpu/ops/tile_kernels.py``:
``composite_fwd_pallas`` → ``csrc/composite_fwd.cu``,
``composite_bwd_pallas`` → ``csrc/composite_bwd.cu``), and the build and
launch counts of the port's compute kernels (also ``csrc/segment_sum.cu``,
wrapped by ``ops/segsum.py``), and the launch of the step's stage mark
``csrc/span_mark.cu`` (``utils/spans.py``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, keyed by a hash of its source,
under ``build/s3gaussian_tpu_torch/`` beside the package, and loaded with
``ctypes``; ``build()`` starts one ``nvcc`` per source, all at once.  A
CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version (``composite.composite_tiles_torch`` /
``composite.composite_tiles_bwd_torch``).

``launch_geometry`` sets a tile's launch (threads, dynamic shared memory)
where the CPU tests reach it; the C entry points take it as arguments.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from s3gaussian_tpu_torch.ops.composite import (N_OUT_ROWS, PAIR_FEAT_DIM,
                                                composite_tiles_bwd_torch,
                                                composite_tiles_torch)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"composite_fwd": _PKG / "csrc" / "composite_fwd.cu",
           "composite_bwd": _PKG / "csrc" / "composite_bwd.cu",
           "segment_sum": _PKG / "csrc" / "segment_sum.cu",
           "span_mark": _PKG / "csrc" / "span_mark.cu"}
# the C entry point of each library, where it is not the source's name
ENTRY = {"span_mark": "span_mark_at"}
HEADER = _PKG / "csrc" / "composite_common.cuh"   # the compositors' own
BUILD_DIR = _PKG.parent / "build" / "s3gaussian_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches made by composite_fwd / composite_bwd /
# segsum.sum_ranges / span_mark (CPU calls do not count).  A launch made
# while the stream captures a CUDA graph runs only when the graph is
# replayed: it goes to ``captured`` instead, and the graph's owner
# (train/graphs.py) adds what it captured once per replay through
# ``count_replay``
launches = 0
bwd_launches = 0
seg_launches = 0
mark_launches = 0
captured = [0, 0]           # forward, backward
seg_captured = 0
mark_captured = 0
_libs: Dict[str, ctypes.CDLL] = {}

# The launch geometry both kernels are compiled for
# (csrc/composite_common.cuh): one block per tile, each thread owning
# PIXELS_PER_THREAD vertically adjacent pixels of one column (pixel_slot),
# pair batches of BATCH staged through a two-deep ring in shared memory.
PIXELS_PER_THREAD = 2
BATCH = 128
MAX_PIXELS = 1024
MAX_THREADS = 512                      # the kernels' __launch_bounds__
_STAGE_ROWS = 10          # data rows of the stream staged per pair
_PARTIAL_STRIDE = 11      # floats per (warp, pair) partial of the backward


class LaunchGeometry(NamedTuple):
    pixels_per_thread: int
    threads: int
    batch: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int


def launch_geometry(tile_x: int, tile_y: int) -> LaunchGeometry:
    """Both kernels' launch for a tile_x × tile_y tile: threads in whole
    warps to cover ``tile_x · ceil(tile_y / PIXELS_PER_THREAD)`` pixel
    columns, and the dynamic shared memory of two ring stages of BATCH
    pairs (plus, in the backward, the per-warp partials: at most 100,352
    bytes, which the C entry points opt in to above 48 KB).  Raises
    ValueError on a tile the kernels cannot serve."""
    if tile_x < 1 or tile_y < 1 or tile_x * tile_y > MAX_PIXELS:
        raise ValueError(f"tile of {tile_x}x{tile_y} pixels: the kernels "
                         f"serve 1 to {MAX_PIXELS} pixels")
    columns = tile_x * -(-tile_y // PIXELS_PER_THREAD)
    threads = -(-columns // 32) * 32
    if threads > MAX_THREADS:
        raise ValueError(f"tile of {tile_x}x{tile_y} pixels needs {threads} "
                         f"threads at {PIXELS_PER_THREAD} pixels each, more "
                         f"than {MAX_THREADS}")
    fwd_smem = 4 * 2 * _STAGE_ROWS * BATCH
    bwd_smem = fwd_smem + 4 * (threads // 32) * _PARTIAL_STRIDE * BATCH
    return LaunchGeometry(PIXELS_PER_THREAD, threads, BATCH, fwd_smem,
                          bwd_smem)


def pixel_slots(geometry: LaunchGeometry, tile_x: int,
                tile_y: int) -> torch.Tensor:
    """[threads, pixels_per_thread] int64: the pixel (row-major in the
    tile) that each (thread, slot) of a launch owns, -1 where none; the
    map of ``csrc/composite_common.cuh::pixel_slot``."""
    ppt = geometry.pixels_per_thread
    t = torch.arange(geometry.threads)[:, None]
    row = (t // tile_x) * ppt + torch.arange(ppt)[None, :]
    return torch.where(row < tile_y, row * tile_x + t % tile_x, -1)


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + HEADER.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every kernel whose library for this source does not exist,
    one ``nvcc`` per source, started together.  Returns nvcc's output
    (registers, shared memory, spills) per kernel, "" where the library
    was already built."""
    todo = {name: library_path(name) for name in SOURCES
            if not library_path(name).exists()}
    logs = {name: "" for name in SOURCES}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, so, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed "
                          f"({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn = getattr(lib, ENTRY.get(name, name))
        # ..., grid_x, grid_y, tile_x, tile_y, threads, smem_bytes
        dims = [i32] * 6
        if name == "span_mark":     # stamps, slot, stream
            fn.argtypes = [ptr, i32, ptr]
        elif name == "composite_fwd":
            fn.argtypes = [ptr, i64, ptr, ptr, *dims, ptr]
        elif name == "composite_bwd":
            fn.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, *dims, ptr]
        else:       # vals, perm, offs, n_ranges, d, out, stream
            fn.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def _count(kind: int) -> None:
    """One launch of the forward (0), backward (1), segment-sum (2) or
    span-mark (3) kernel."""
    global launches, bwd_launches, seg_launches, seg_captured
    global mark_launches, mark_captured
    if torch.cuda.is_current_stream_capturing():
        if kind == 2:
            seg_captured += 1
        elif kind == 3:
            mark_captured += 1
        else:
            captured[kind] += 1
    elif kind == 0:
        launches += 1
    elif kind == 1:
        bwd_launches += 1
    elif kind == 2:
        seg_launches += 1
    else:
        mark_launches += 1


def count_replay(fwd: int, bwd: int, seg: int = 0, marks: int = 0) -> None:
    """A replay of a CUDA graph that captured ``fwd`` forward, ``bwd``
    backward, ``seg`` segment-sum and ``marks`` span-mark launches
    launched them again."""
    global launches, bwd_launches, seg_launches, mark_launches
    launches += fwd
    bwd_launches += bwd
    seg_launches += seg
    mark_launches += marks


def span_mark(stamps: torch.Tensor, slot: int) -> None:
    """Launch ``csrc/span_mark.cu`` on the current stream: the device's
    clock (ns) into ``stamps[slot]``, an int64 CUDA tensor; counted in
    ``mark_launches``."""
    lib = _load("span_mark")
    with torch.cuda.device(stamps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.span_mark_at(stamps.data_ptr(), slot, stream)
    if err != 0:
        raise RuntimeError(f"span_mark kernel launch failed: CUDA error "
                           f"{err}")
    _count(3)


def _check_stream(name: str, pair_feat: torch.Tensor,
                  tile_starts: torch.Tensor, grid_x: int, grid_y: int,
                  tile_x: int, tile_y: int) -> None:
    n_tiles = grid_x * grid_y
    if pair_feat.dim() != 2 or pair_feat.shape[0] != PAIR_FEAT_DIM:
        raise ValueError(f"pair_feat must be [{PAIR_FEAT_DIM}, M], got "
                         f"{tuple(pair_feat.shape)}")
    if tile_starts.shape != (n_tiles + 1,):
        raise ValueError(f"tile_starts must be [{n_tiles + 1}], got "
                         f"{tuple(tile_starts.shape)}")
    if pair_feat.device != tile_starts.device:
        raise ValueError("pair_feat and tile_starts on different devices")
    if pair_feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not "
                         f"{pair_feat.device}")


def _check_launch(name: str, tensors, tile_starts: torch.Tensor,
                  tile_x: int, tile_y: int) -> LaunchGeometry:
    if (any(t.dtype != torch.float32 for t in tensors)
            or tile_starts.dtype != torch.int32):
        raise TypeError(f"{name} takes float32 tensors and int32 "
                        f"tile_starts, got "
                        f"{[t.dtype for t in tensors]} and "
                        f"{tile_starts.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, tile_starts)):
        raise ValueError(f"{name} takes contiguous tensors")
    return launch_geometry(tile_x, tile_y)


def composite_fwd(pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                  grid_x: int, grid_y: int, tile_x: int,
                  tile_y: int) -> torch.Tensor:
    """pair_feat [16, M] float32 (feature-major sorted pair stream),
    tile_starts [T+1] int32 -> [T, 8, P] float32."""
    _check_stream("composite_fwd", pair_feat, tile_starts, grid_x, grid_y,
                  tile_x, tile_y)
    if pair_feat.device.type == "cpu":
        return composite_tiles_torch(pair_feat, tile_starts, grid_x, grid_y,
                                     tile_x, tile_y)
    geo = _check_launch("composite_fwd", (pair_feat,), tile_starts, tile_x,
                        tile_y)
    out = torch.empty(grid_x * grid_y, N_OUT_ROWS, tile_x * tile_y,
                      dtype=torch.float32, device=pair_feat.device)
    lib = _load("composite_fwd")
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_fwd(pair_feat.data_ptr(), pair_feat.shape[1],
                                tile_starts.data_ptr(), out.data_ptr(),
                                grid_x, grid_y, tile_x, tile_y, geo.threads,
                                geo.fwd_smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error "
                           f"{err}")
    _count(0)
    return out


def composite_bwd(pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, grid_x: int,
                  grid_y: int, tile_x: int, tile_y: int) -> torch.Tensor:
    """The compositor's VJP: pair_feat [16, M], tile_starts [T+1], the
    forward output ``out`` and its cotangent ``dout`` [T, 8, P] ->
    per-pair gradients [16, M] in sorted-pair order (rows 10-15, slots
    past the last tile range and pairs after an early exit are 0)."""
    _check_stream("composite_bwd", pair_feat, tile_starts, grid_x, grid_y,
                  tile_x, tile_y)
    p = tile_x * tile_y
    want = (grid_x * grid_y, N_OUT_ROWS, p)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{tuple(t.shape)}")
        if t.device != pair_feat.device:
            raise ValueError(f"{name} is on {t.device}, pair_feat on "
                             f"{pair_feat.device}")
    if pair_feat.device.type == "cpu":
        return composite_tiles_bwd_torch(pair_feat, tile_starts, out, dout,
                                         grid_x, grid_y, tile_x, tile_y)
    geo = _check_launch("composite_bwd", (pair_feat, out, dout), tile_starts,
                        tile_x, tile_y)
    grads = torch.zeros(PAIR_FEAT_DIM, pair_feat.shape[1],
                        dtype=torch.float32, device=pair_feat.device)
    lib = _load("composite_bwd")
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_bwd(pair_feat.data_ptr(), pair_feat.shape[1],
                                tile_starts.data_ptr(), out.data_ptr(),
                                dout.data_ptr(), grads.data_ptr(), grid_x,
                                grid_y, tile_x, tile_y, geo.threads,
                                geo.bwd_smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error "
                           f"{err}")
    _count(1)
    return grads


class CompositeTiles(torch.autograd.Function):
    """``composite_fwd`` with ``composite_bwd`` as its backward.  The
    gradient flows to ``pair_feat`` only; rows 5-7 of the output (the
    contributor count and padding) are not differentiable and their
    cotangent is ignored."""

    @staticmethod
    def forward(ctx, pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                grid_x: int, grid_y: int, tile_x: int,
                tile_y: int) -> torch.Tensor:
        out = composite_fwd(pair_feat, tile_starts, grid_x, grid_y, tile_x,
                            tile_y)
        ctx.save_for_backward(pair_feat, tile_starts, out)
        ctx.dims = (grid_x, grid_y, tile_x, tile_y)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        pair_feat, tile_starts, out = ctx.saved_tensors
        grads = composite_bwd(pair_feat, tile_starts, out, dout.contiguous(),
                              *ctx.dims)
        return grads, None, None, None, None, None
