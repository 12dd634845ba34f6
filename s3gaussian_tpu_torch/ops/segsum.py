"""Ordered sums of contiguous row ranges, the step under
``ops/gridsample.py::segment_sum`` (the field's grid gradients): the CUDA
kernel ``csrc/segment_sum.cu`` and its plain version.

``sum_ranges(vals, perm, offs)`` returns ``out[p] = Σ vals[row(j)]`` over
``j`` in ``[offs[p], offs[p+1])``, added in row order from zero, where
``row(j)`` is ``perm[j]`` (the gather into sorted order, fused into the
sum) or ``j``.  A CUDA tensor launches the kernel or raises; only a CPU
tensor takes the plain version, ``ranges_torch`` (one
``torch.segment_reduce``, which adds in the same order).  Neither uses
atomics: a sum gives the same bits on every run.
"""

from __future__ import annotations

from typing import Optional

import torch

from s3gaussian_tpu_torch.ops import tile_kernels as tk

MAX_COLS = 128          # csrc/segment_sum.cu: 4 columns a lane


def ranges_torch(vals: torch.Tensor, perm: Optional[torch.Tensor],
                 offs: torch.Tensor) -> torch.Tensor:
    """The plain version of ``sum_ranges``."""
    data = vals if perm is None else vals[perm]
    return torch.segment_reduce(data, "sum", offsets=offs, axis=0,
                                unsafe=True)


def sum_ranges(vals: torch.Tensor, perm: Optional[torch.Tensor],
               offs: torch.Tensor) -> torch.Tensor:
    """vals [R, D] float32; perm [K] int64 or None; offs [P+1] int64,
    non-decreasing, within [0, K] (or [0, R]) -> [P, D] float32."""
    if vals.dim() != 2 or offs.dim() != 1:
        raise ValueError(f"vals must be [R, D] and offs [P+1], got "
                         f"{tuple(vals.shape)} and {tuple(offs.shape)}")
    if any(t.device != vals.device for t in (offs, perm) if t is not None):
        raise ValueError("vals, perm and offs on different devices")
    if vals.device.type == "cpu":
        return ranges_torch(vals, perm, offs)
    if vals.device.type != "cuda":
        raise ValueError(f"sum_ranges runs on CPU or CUDA tensors, not "
                         f"{vals.device}")
    if vals.dtype != torch.float32 or offs.dtype != torch.int64 or (
            perm is not None and perm.dtype != torch.int64):
        raise TypeError(f"sum_ranges takes float32 vals and int64 perm and "
                        f"offs, got {vals.dtype}, "
                        f"{None if perm is None else perm.dtype}, "
                        f"{offs.dtype}")
    if not all(t.is_contiguous() for t in (vals, offs, perm)
               if t is not None):
        raise ValueError("sum_ranges takes contiguous tensors")
    d = vals.shape[1]
    if d > MAX_COLS:
        raise ValueError(f"{d} columns: the kernel sums at most {MAX_COLS}")
    n = offs.shape[0] - 1
    out = torch.empty((n, d), dtype=torch.float32, device=vals.device)
    lib = tk._load("segment_sum")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_sum(vals.data_ptr(),
                              None if perm is None else perm.data_ptr(),
                              offs.data_ptr(), n, d, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    tk._count("segment_sum")
    return out
