"""Bilinear/trilinear grid sampling, align_corners=True with border
padding (port of ``s3gaussian_tpu/ops/gridsample.py``).

Written as explicit corner gathers and lerps rather than
``F.grid_sample`` so that a ``compute_dtype`` grid (bfloat16 plane
values) is sampled the way the JAX package samples it: the gathered
values keep the grid's dtype while coordinates and interpolation weights
stay float32, and the lerp promotes to float32.

Gradients are autograd, except for the row gathers: ``gather_rows``
accumulates the grid gradient in float32 and rounds it to the grid's
dtype once, as the JAX package's hand-written VJP of the time rows does
(``gridsample.py:143-157``).  Plain autograd would sum tens of thousands
of bfloat16 products per plane cell in bfloat16.
"""

from __future__ import annotations

import torch


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` for each index tensor; the table's gradient from
    all of them is summed in one float32 buffer."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, *idxs: torch.Tensor):
        ctx.save_for_backward(*idxs)
        ctx.shape = table.shape
        ctx.dtype = table.dtype
        return tuple(table[idx] for idx in idxs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        acc = torch.zeros(ctx.shape, dtype=torch.float32,
                          device=grads[0].device)
        for idx, grad in zip(ctx.saved_tensors, grads):
            acc.index_add_(0, idx, grad.to(torch.float32))
        return (acc.to(ctx.dtype),) + (None,) * len(grads)


def gather_rows(table: torch.Tensor, *idxs: torch.Tensor):
    """table [R, C], each idx [K] int64 -> a tuple of table[idx] [K, C]."""
    return _GatherRows.apply(table, *idxs)


def _axis(v: torch.Tensor, n: int):
    """Normalized coordinate -> (low index, high index, weight [N,1])."""
    u = torch.clamp((v + 1.0) * 0.5 * (n - 1), 0.0, n - 1)
    u0 = torch.floor(u)
    i0 = u0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n - 1), (u - u0)[:, None]


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, H, W]; coords [N, 2] in [-1, 1], (x -> W, y -> H) as in
    torch's grid_sample.  Returns [N, C]."""
    c, h, w = grid.shape
    x0, x1, wx = _axis(coords[:, 0], w)
    y0, y1, wy = _axis(coords[:, 1], h)
    rows = grid.reshape(c, h * w).t()                   # [H*W, C]
    v00, v01, v10, v11 = gather_rows(rows, y0 * w + x0, y0 * w + x1,
                                     y1 * w + x0, y1 * w + x1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, D, H, W]; coords [N, 3] in [-1, 1], (x -> W, y -> H,
    z -> D).  Returns [N, C]."""
    c, d, h, w = grid.shape
    x0, x1, wx = _axis(coords[:, 0], w)
    y0, y1, wy = _axis(coords[:, 1], h)
    z0, z1, wz = _axis(coords[:, 2], d)
    flat = grid.reshape(c, -1).t()                      # [D*H*W, C]

    v = gather_rows(flat, *((z * h + y) * w + x for z in (z0, z1)
                            for y in (y0, y1) for x in (x0, x1)))

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(v[0], v[1], wx)
    c01 = lerp(v[2], v[3], wx)
    c10 = lerp(v[4], v[5], wx)
    c11 = lerp(v[6], v[7], wx)
    return lerp(lerp(c00, c01, wy), lerp(c10, c11, wy), wz)


def sample_time_plane(plane: torch.Tensor, sx: torch.Tensor,
                      t_scalar: torch.Tensor) -> torch.Tensor:
    """== grid_sample_2d(plane, stack([sx, t], 1)) for one scalar t.

    plane [C, Ht, W] (time on the row axis); sx [N] in [-1, 1]; t_scalar a
    0-d tensor in [-1, 1].  The t-lerp folds into one [C, W] row before
    the per-point work (computed in the plane's dtype, as in JAX), so each
    point gathers two values per channel instead of four."""
    c, h, w = plane.shape
    if h == 1:
        sig = plane[:, 0, :]
    else:
        y = torch.clamp((t_scalar + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
        y0 = torch.clamp(torch.floor(y), 0.0, h - 2)
        wy = (y - y0).to(plane.dtype)
        i0 = y0.to(torch.int64).reshape(1)
        rows_t = plane.index_select(1, torch.cat([i0, i0 + 1]))  # [C,2,W]
        sig = (1 - wy) * rows_t[:, 0, :] + wy * rows_t[:, 1, :]
    x0, x1, wx = _axis(sx, w)
    v0, v1 = gather_rows(sig.t(), x0, x1)               # [N, C] each
    return (1 - wx) * v0 + wx * v1
