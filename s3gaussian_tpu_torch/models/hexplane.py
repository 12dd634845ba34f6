"""Multi-resolution hexplane (K-Planes) spacetime encoder and its
regularizers (port of ``s3gaussian_tpu/models/hexplane.py``).

6 planes per scale = C(4,2) coordinate pairs over (x, y, z, t); spatial
planes init U(0.1, 0.5), time planes init to 1; per-scale feature = the
product of the 6 bilinear plane samples; scales concatenated.  The
parameters are an ``nn.ParameterDict`` keyed ``scale{s}_plane{i}`` like
the JAX pytree.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
from torch import nn

from s3gaussian_tpu_torch.ops.gridsample import (grid_sample_2d,
                                                 hexplane_query,
                                                 sample_time_plane)

COO_COMBS = tuple(itertools.combinations(range(4), 2))
# = ((0,1),(0,2),(0,3),(1,2),(1,3),(2,3)); planes 2,4,5 involve time
SPATIAL_PLANES = (0, 1, 3)
TIME_PLANES = (2, 4, 5)


def init_hexplane(generator: torch.Generator, out_dim: int = 32,
                  resolution: Sequence[int] = (64, 64, 64, 25),
                  multires: Sequence[int] = (1, 2, 4, 8),
                  device: torch.device | str = "cuda") -> nn.ParameterDict:
    """Plane (scale s, pair i): [out_dim, reso[c1]*m, reso[c0]*m], the
    multiplier m on spatial dims only.  ``generator`` is a CPU generator;
    the planes are drawn on the CPU and moved to ``device``."""
    params = {}
    for s, mult in enumerate(multires):
        reso = [r * mult for r in resolution[:3]] + [resolution[3]]
        for i, comb in enumerate(COO_COMBS):
            shape = (out_dim, reso[comb[1]], reso[comb[0]])
            if 3 in comb:
                p = torch.ones(shape)
            else:
                p = 0.1 + 0.4 * torch.rand(shape, generator=generator)
            params[f"scale{s}_plane{i}"] = nn.Parameter(p.to(device))
    return nn.ParameterDict(params)


def normalize_aabb(pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """(pts - aabb[0]) * 2/(aabb[1]-aabb[0]) - 1.  The reference stores
    aabb as [max; min] and normalizes with aabb[0] = max; that sign flip is
    kept (PARITY.md #13/#14)."""
    return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def query_hexplane(params: nn.ParameterDict, pts: torch.Tensor,
                   t: torch.Tensor, aabb: torch.Tensor, n_scales: int,
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """pts [N,3] world, t [N,1] or a 0-d tensor in [0,1] -> [N, out_dim·n_scales].

    ``compute_dtype`` (e.g. bfloat16) casts the plane values before the
    gathers; coordinates and weights stay float32.  CUDA tensors go
    through the kernels of ``csrc/hexplane.cu``
    (``gridsample.hexplane_query``: the plain version's bits; a 0-d ``t``
    only), CPU tensors through the plain version,
    ``query_hexplane_plain``."""
    if pts.device.type != "cuda":
        return query_hexplane_plain(params, pts, t, aabb, n_scales,
                                    compute_dtype)
    return hexplane_query(normalize_aabb(pts, aabb), t, [
        params[f"scale{s}_plane{i}"] if compute_dtype is None
        else params[f"scale{s}_plane{i}"].to(compute_dtype)
        for s in range(n_scales) for i in range(len(COO_COMBS))])


def query_hexplane_plain(params: nn.ParameterDict, pts: torch.Tensor,
                         t: torch.Tensor, aabb: torch.Tensor, n_scales: int,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """``query_hexplane`` in plain PyTorch ops on any device.  A 0-d ``t``
    (one time for every point, what rendering always passes) takes the
    scalar-row path for the three spatiotemporal planes."""
    t_scalar = t.dim() == 0
    x = normalize_aabb(pts, aabb)
    feats = []
    for s in range(n_scales):
        acc = None
        for i, comb in enumerate(COO_COMBS):
            plane = params[f"scale{s}_plane{i}"]
            if compute_dtype is not None:
                plane = plane.to(compute_dtype)
            if 3 in comb and t_scalar:
                v = sample_time_plane(plane, x[:, comb[0]], t)
            else:
                coords = torch.cat([x[:, c:c + 1] if c < 3 else t
                                    for c in comb], -1)
                v = grid_sample_2d(plane, coords)
            acc = v if acc is None else acc * v
        feats.append(acc.to(torch.float32))
    return torch.cat(feats, -1)


# --- regularizers (reference gaussian_model.py:710-749, regulation.py:22-28)

def _plane_smoothness(p: torch.Tensor) -> torch.Tensor:
    """Mean squared second difference along the plane's row axis (the
    pair's second coordinate: time for the spatiotemporal planes)."""
    d1 = p[:, 1:, :] - p[:, :-1, :]
    d2 = d1[:, 1:, :] - d1[:, :-1, :]
    return torch.mean(torch.square(d2))


def plane_tv(params, n_scales: int) -> torch.Tensor:
    """Smoothness over the three spatial planes (_plane_regulation)."""
    return sum(_plane_smoothness(params[f"scale{s}_plane{i}"])
               for s in range(n_scales) for i in SPATIAL_PLANES)


def time_smoothness(params, n_scales: int) -> torch.Tensor:
    """Smoothness over the three spatiotemporal planes (_time_regulation)."""
    return sum(_plane_smoothness(params[f"scale{s}_plane{i}"])
               for s in range(n_scales) for i in TIME_PLANES)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: +1 at x == 0 (``torch.abs`` gives 0).
    The time planes start at exactly 1, so at 0 is where l1_time starts."""
    return torch.where(x >= 0, x, -x)


def l1_time(params, n_scales: int) -> torch.Tensor:
    """mean |1 - plane| over the spatiotemporal planes (_l1_regulation)."""
    return sum(torch.mean(_abs(1.0 - params[f"scale{s}_plane{i}"]))
               for s in range(n_scales) for i in TIME_PLANES)


def compute_regulation(params, n_scales: int, time_smoothness_weight: float,
                       l1_time_weight: float,
                       plane_tv_weight: float) -> torch.Tensor:
    """The weighting of reference gaussian_model.py:745-749."""
    return (plane_tv_weight * plane_tv(params, n_scales)
            + time_smoothness_weight * time_smoothness(params, n_scales)
            + l1_time_weight * l1_time(params, n_scales))
