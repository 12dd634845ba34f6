#!/usr/bin/env python3
"""Time the deformation field's row-gather backward on the card under
several ways of summing each plane cell's gradients, and check which of
them repeat bit for bit.

The field is the default ``ModelHiddenParams`` hexplane (bfloat16 planes,
32 channels, 4 scales) queried at N random points at one time, as a train
step queries it; the cotangent is random.  Each way replaces
``ops/gridsample.py::segment_sum`` (the sum behind every plane's
gradient):

  levels     the port's: a stable sort, then sums in levels of ranges of
             at most PIECE rows by the CUDA kernel ``csrc/segment_sum.cu``
             (no atomics);
  levels_plain  the same levels summed by its plain version,
             ``torch.segment_reduce`` after a gather into sorted order;
  one_level  a stable sort, then one ``segment_reduce`` over each cell's
             rows (no atomics; a cell's rows are summed by one thread);
  index_put  ``index_put_(accumulate=True)``: PyTorch's sort-based
             accumulation (``indexing_backward_kernel``);
  index_add  ``index_add_``, float32 atomics (the sum before).

Run on the card from the repository root:

    python scripts/torch_field_bwd_ab.py [N ...]     # default 204800 1507328

Prints one line per (N, way): the backward's median ms (CUDA events) and
whether two backward passes gave the same bits, with the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from s3gaussian_tpu_torch.bench import card_line  # noqa: E402
from s3gaussian_tpu_torch.config import ModelHiddenParams  # noqa: E402
from s3gaussian_tpu_torch.device import configure_device  # noqa: E402
from s3gaussian_tpu_torch.models.deformation import \
    DeformationField  # noqa: E402
from s3gaussian_tpu_torch.models.hexplane import query_hexplane  # noqa: E402
from s3gaussian_tpu_torch.ops import gridsample as gs  # noqa: E402
from s3gaussian_tpu_torch.ops import segsum  # noqa: E402

REPS = 10


def _sorted(keys, vals):
    sk, perm = torch.sort(keys.to(torch.int32), stable=True)
    return sk, vals.to(torch.float32)[perm]


def one_level(keys, vals, n_rows):
    sk, data = _sorted(keys, vals)
    offs = torch.searchsorted(sk, torch.arange(
        n_rows + 1, dtype=sk.dtype, device=sk.device))
    return torch.segment_reduce(data, "sum", offsets=offs, axis=0,
                                unsafe=True)


def index_put(keys, vals, n_rows):
    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_put_((keys.long(),), vals.to(torch.float32),
                          accumulate=True)


def index_add(keys, vals, n_rows):
    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, keys, vals.to(torch.float32))


def levels_plain(keys, vals, n_rows):
    gs.sum_ranges = segsum.ranges_torch
    try:
        return levels(keys, vals, n_rows)
    finally:
        gs.sum_ranges = segsum.sum_ranges


levels = gs.segment_sum
WAYS = {"levels": levels, "levels_plain": levels_plain,
        "one_level": one_level, "index_put": index_put,
        "index_add": index_add}


def main(sizes) -> int:
    dev = configure_device("cuda")
    card = card_line()
    hp = ModelHiddenParams()
    field = DeformationField(hp, torch.Generator().manual_seed(0), dev)
    aabb = torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                        device=dev)
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(n)
        pts = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * 60
        t = torch.tensor(0.4, device=dev)
        planes = list(field.grid.values())
        out = query_hexplane(field.grid, pts, t, aabb, len(hp.multires),
                             compute_dtype=torch.bfloat16)
        cot = torch.randn(out.shape, generator=gen, device=dev)
        for name, fn in WAYS.items():
            gs.segment_sum = fn

            def backward():
                out = query_hexplane(field.grid, pts, t, aabb,
                                     len(hp.multires),
                                     compute_dtype=torch.bfloat16)
                return torch.autograd.grad(out, planes, cot)

            first, second = backward(), backward()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            ms = []
            for _ in range(REPS):
                out = query_hexplane(field.grid, pts, t, aabb,
                                     len(hp.multires),
                                     compute_dtype=torch.bfloat16)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                torch.autograd.grad(out, planes, cot)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            ms.sort()
            print(f"field backward N={n} {name}: median "
                  f"{ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, {REPS} "
                  f"reps, CUDA events), repeats bit for bit: {same} "
                  f"({card})", flush=True)
            del first, second
    return 0


if __name__ == "__main__":
    sys.exit(main([int(x) for x in sys.argv[1:]] or [204_800, 1_507_328]))
