# Plain stand-in for s3gaussian_tpu_torch/ops/segsum.py at commit
# 0fe8bd83fbe2d3b430992244fdc79098999720ec: ranges_torch on every device; no CUDA kernel.
"""Ordered sums of contiguous row ranges for the plain reference."""

from __future__ import annotations

from typing import Optional

import torch


def sum_ranges(vals: torch.Tensor, perm: Optional[torch.Tensor],
               offs: torch.Tensor) -> torch.Tensor:
    """out[p] = sum of vals[row(j)] over j in [offs[p],
    offs[p+1]), row(j) being perm[j] or j: one
    torch.segment_reduce after the gather."""
    data = vals if perm is None else vals[perm]
    return torch.segment_reduce(data, "sum", offsets=offs, axis=0,
                                unsafe=True)
