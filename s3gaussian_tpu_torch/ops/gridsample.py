"""Bilinear/trilinear grid sampling, align_corners=True with border
padding (port of ``s3gaussian_tpu/ops/gridsample.py``, forward only).

Written as explicit corner gathers and lerps rather than
``F.grid_sample`` so that a ``compute_dtype`` grid (bfloat16 plane
values) is sampled the way the JAX package samples it: the gathered
values keep the grid's dtype while coordinates and interpolation weights
stay float32, and the lerp promotes to float32.
"""

from __future__ import annotations

import torch


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
    v00, v01 = rows[y0 * w + x0], rows[y0 * w + x1]
    v10, v11 = rows[y1 * w + x0], rows[y1 * w + x1]
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

    def corner(z, y, x):
        return flat[(z * h + y) * w + x]

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(corner(z0, y0, x0), corner(z0, y0, x1), wx)
    c01 = lerp(corner(z0, y1, x0), corner(z0, y1, x1), wx)
    c10 = lerp(corner(z1, y0, x0), corner(z1, y0, x1), wx)
    c11 = lerp(corner(z1, y1, x0), corner(z1, y1, x1), wx)
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
    rows = sig.t()                                      # [W, C]
    return (1 - wx) * rows[x0] + wx * rows[x1]
