# Frozen copy of s3gaussian_tpu_torch/ops/compact.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Scatter-free compaction gather (port of
``s3gaussian_tpu/ops/compact.py``).

``take_compact`` gathers pool rows at the increasing candidate indices of
a stable visible-first sort.  Its backward expands the gradient back to
the pool by rank arithmetic: because the compaction is stable, pool row
i's candidate position is ``rank(i) = cumsum(visible)[i] - 1``, so the
backward is a gather too, where ``x[cand]`` under autograd would
accumulate through ``index_put_`` (a scatter with atomics).
"""

from __future__ import annotations

import torch


def candidates(visible: torch.Tensor, nr: int) -> torch.Tensor:
    """The first ``nr`` pool indices in visible-first order, each class
    in increasing index (JAX's stable ``lax.sort((key, arange))``)."""
    order = torch.sort((~visible).to(torch.int32), stable=True).indices
    return order[:nr]


def expand_by_rank(values: torch.Tensor, visible: torch.Tensor
                   ) -> torch.Tensor:
    """Per-candidate ``values`` [NR, ...] back to pool rows [N, ...]:
    row i takes candidate ``rank(i)`` when it is visible and among the NR
    candidates, else zero (False)."""
    nr = values.shape[0]
    rank = torch.cumsum(visible.to(torch.int64), 0) - 1
    ok = (visible & (rank < nr)).reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(ok, values[torch.clamp(rank, 0, nr - 1)],
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


class TakeCompact(torch.autograd.Function):
    """x[cand] whose backward is ``expand_by_rank`` of the gradient."""

    @staticmethod
    def forward(ctx, x, cand, visible):
        ctx.save_for_backward(visible)
        return x[cand]

    @staticmethod
    def backward(ctx, g):
        (visible,) = ctx.saved_tensors
        return expand_by_rank(g, visible), None, None


def take_compact(x: torch.Tensor, cand: torch.Tensor,
                 visible: torch.Tensor) -> torch.Tensor:
    """x: [N, ...] pool tensor; cand: [NR] candidate pool indices from
    ``candidates(visible, NR)``; visible: [N] bool.  Returns x[cand]."""
    return TakeCompact.apply(x, cand, visible)
