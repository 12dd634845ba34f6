# Frozen copy of s3gaussian_tpu_torch/ops/rasterizer.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Differentiable Gaussian rasterizer (port of
``s3gaussian_tpu/ops/rasterizer.py::rasterize``).

Dataflow, in three stages that ``chip_smoke.py`` also times one by one:

  ``project_and_key``: build_cov3d → project → SH colours → pair keys on
  detached inputs → [16, N] feature rows;
  ``sort_stream``: ONE stable (key, slot) sort → ONE gather of the 10
  data rows at each sorted slot's column → tile ranges;
  ``tile_kernels.CompositeTiles``: the CUDA compositors, forward and
  backward (plain PyTorch on CPU tensors) → ``unpack_tiles`` →
  ``color = rgb + final_T·bg``.

Keys, the sort and the tile ranges are computed on detached tensors.  The
gather is ``SortStreamGather``, the counterpart of the JAX package's
``composite_core`` custom VJP (``s3gaussian_tpu/ops/rasterizer.py:226-305``),
whose backward has no scatter: the per-pair gradients past ``n_pairs``
are zeroed, un-sorted by emission slot (a permutation: each slot is
written once), summed over the rect axis contiguously (over the two
sections' strides, 4 and ``rect_cap - 4``, plus each granted big's
periphery at ``big_rank``, with two-class emission), and expanded back to
the pool by rank, a gather.  Autograd of ``data[:, gid]`` would
accumulate through ``index_put_``.
Every other gradient (EWA projection, covariance, SH) is autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.frozen.ref.config import RasterConfig
from benchmark.frozen.ref.ops import composite as comp
from benchmark.frozen.ref.ops.binning import (PairKeys, make_pair_keys,
                                              sort_pairs, tile_ranges)
from benchmark.frozen.ref.ops.project import (ProjectedGaussians, build_cov3d,
                                              project_gaussians, sh_to_color)
from benchmark.frozen.ref.ops.tile_kernels import CompositeTiles


class RasterSettings(NamedTuple):
    """Mirror of GaussianRasterizationSettings."""

    image_height: int
    image_width: int
    tanfovx: float | torch.Tensor   # a float or a 0-d tensor
    tanfovy: float | torch.Tensor
    bg: torch.Tensor            # [3]
    scale_modifier: float
    viewmatrix: torch.Tensor    # [4,4] row-vector W2C^T
    projmatrix: torch.Tensor    # [4,4] row-vector full projection
    sh_degree: int
    campos: torch.Tensor        # [3]
    prefiltered: bool = False
    debug: bool = False


def grid_dims(settings: RasterSettings, cfg: RasterConfig) -> tuple[int, int]:
    return (-(-settings.image_width // cfg.tile_x),
            -(-settings.image_height // cfg.tile_y))


def project_and_key(settings: RasterSettings, means3d: torch.Tensor,
                    opacities: torch.Tensor,
                    scales: Optional[torch.Tensor] = None,
                    rotations: Optional[torch.Tensor] = None,
                    shs: Optional[torch.Tensor] = None,
                    colors_precomp: Optional[torch.Tensor] = None,
                    cov3d_precomp: Optional[torch.Tensor] = None,
                    alive: Optional[torch.Tensor] = None,
                    cfg: RasterConfig = RasterConfig(),
                    mean2d_tap: Optional[torch.Tensor] = None
                    ) -> tuple[ProjectedGaussians, PairKeys, torch.Tensor]:
    """Stage 1: projection, colours and unsorted pair keys.
    Returns (proj, pair keys, feat_pool [16, N])."""
    grid_x, grid_y = grid_dims(settings, cfg)
    cov3d = (build_cov3d(scales, rotations, settings.scale_modifier)
             if cov3d_precomp is None else cov3d_precomp)
    proj = project_gaussians(
        means3d, cov3d, settings.viewmatrix, settings.projmatrix,
        settings.tanfovx, settings.tanfovy, settings.image_width,
        settings.image_height, tile_x=cfg.tile_x, tile_y=cfg.tile_y,
        mean2d_tap=mean2d_tap, alive=alive,
        opacities=opacities if cfg.tight_rect else None)
    colors = (sh_to_color(shs, means3d, settings.campos, settings.sh_degree)
              if colors_precomp is None else colors_precomp)
    nr = min(cfg.max_visible, means3d.shape[0])
    nb = (min(cfg.big_budget, nr)
          if (cfg.big_budget > 0 and cfg.rect_cap > 4 and cfg.rect_w >= 2
              and cfg.rect_h >= 2) else 0)
    pk = make_pair_keys(
        ProjectedGaussians(*[x.detach() for x in proj]), grid_x, grid_y,
        cfg.max_visible, cfg.rect_w, cfg.rect_h, cfg.tile_x, cfg.tile_y,
        opacities=opacities.detach() if cfg.tight_rect else None,
        big_budget=nb)
    feat_pool = comp.pack_pool_features(proj.xy, proj.conic, opacities,
                                        colors, proj.depth)
    return proj, pk, feat_pool


class SortStreamGather(torch.autograd.Function):
    """The 10 data rows of the pair stream: ``pool_rows`` [10, N] at each
    sorted pair's column of the render set (``sel``, then the granted
    bigs' ``big_sel`` with two-class emission).  The backward is JAX's:
    see the module's docstring."""

    @staticmethod
    def forward(ctx, pool_rows, slots, n_pairs, pk: PairKeys, rect_cap: int,
                m: int):
        nr = pk.sel.shape[0]
        n_pool = pool_rows.shape[1]
        data = pool_rows if nr >= n_pool else pool_rows[:, pk.sel]
        if pk.big_sel is None:
            gid = slots // rect_cap
        else:
            # two sections: cores at stride 4, then the bigs' peripheries
            data = torch.cat([data, pool_rows[:, pk.big_sel]], 1)
            m1 = 4 * nr
            gid = torch.where(slots < m1, slots // 4,
                              nr + (slots - m1) // (rect_cap - 4))
        two_class = pk.big_sel is not None
        ctx.save_for_backward(slots, n_pairs, pk.visible,
                              pk.big_granted if two_class else None,
                              pk.big_rank if two_class else None)
        ctx.dims = (nr, n_pool, rect_cap, m,
                    pk.big_sel.shape[0] if two_class else 0)
        return data[:, gid]

    @staticmethod
    def backward(ctx, g):
        slots, n_pairs, visible, big_granted, big_rank = ctx.saved_tensors
        nr, n_pool, rect_cap, m, nb = ctx.dims
        bp = slots.shape[0]
        # the pairs past n_pairs (the invalid tail) carry no gradient
        live = torch.arange(bp, device=g.device) < n_pairs
        g = torch.where(live[None, :], g, 0.0)
        # un-sort by emission slot: a permutation, so each slot is written
        # once (slots the budget cut keep zero)
        d_slot = g.new_zeros((g.shape[0], m)).index_copy_(1, slots, g)
        if nb > 0:
            m1 = 4 * nr
            d_compact = d_slot[:, :m1].reshape(-1, nr, 4).sum(-1)
            d_big = d_slot[:, m1:].reshape(-1, nb, rect_cap - 4).sum(-1)
            # periphery row i is the i-th granted big in render-slot order
            d_compact = d_compact + torch.where(
                big_granted[None, :],
                d_big[:, torch.clamp(big_rank, 0, nb - 1).long()], 0.0)
        else:
            d_compact = d_slot.reshape(-1, nr, rect_cap).sum(-1)
        if nr >= n_pool:
            # no compaction: render slot j is pool row j
            d_pool = torch.where(visible[None, :], d_compact, 0.0)
        else:
            # the compaction is stable, so pool row i sits at render slot
            # rank(i): a gather, not a scatter
            rank = torch.cumsum(visible.to(torch.int64), 0) - 1
            d_pool = torch.where((visible & (rank < nr))[None, :],
                                 d_compact[:, torch.clamp(rank, 0, nr - 1)],
                                 0.0)
        return d_pool, None, None, None, None, None


def sort_stream(feat_pool: torch.Tensor, pk: PairKeys, n_tiles: int,
                rect_cap: int, pair_budget: int):
    """Stage 2: one stable (key, slot) sort, one gather of the 10 data rows
    at the sorted, budget-truncated positions, tile ranges.
    Returns (stream [16, bp], tile_starts [T+1] int32, n_pairs, overflow_pairs)."""
    m = pk.keys.shape[0]
    bp = min(m, pair_budget)
    sorted_tile, sorted_slot = sort_pairs(pk)
    tile_starts, n_pairs, overflow_pairs = tile_ranges(sorted_tile, n_tiles,
                                                       bp)
    rows = SortStreamGather.apply(feat_pool[:comp.N_DATA_ROWS],
                                  sorted_slot[:bp], n_pairs, pk, rect_cap, m)
    const = torch.zeros(comp.PAIR_FEAT_DIM - comp.N_DATA_ROWS, bp,
                        dtype=rows.dtype, device=rows.device)
    const[0] = 1.0                                   # the FONE channel
    stream = torch.cat([rows, const], 0).contiguous()
    return stream, tile_starts, n_pairs, overflow_pairs


def rasterize(settings: RasterSettings, means3d: torch.Tensor,
              opacities: torch.Tensor,
              scales: Optional[torch.Tensor] = None,
              rotations: Optional[torch.Tensor] = None,
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              cov3d_precomp: Optional[torch.Tensor] = None,
              mean2d_tap: Optional[torch.Tensor] = None,
              alive: Optional[torch.Tensor] = None,
              cfg: RasterConfig = RasterConfig()):
    """Render one view from activated inputs.  Returns
    (color [3,H,W], radii [N], depth [H,W], aux); differentiable with
    respect to every float input and ``mean2d_tap``."""
    h, w = settings.image_height, settings.image_width
    grid_x, grid_y = grid_dims(settings, cfg)
    proj, pk, feat_pool = project_and_key(
        settings, means3d, opacities, scales, rotations, shs, colors_precomp,
        cov3d_precomp, alive, cfg, mean2d_tap)
    stream, tile_starts, n_pairs, overflow_pairs = sort_stream(
        feat_pool, pk, grid_x * grid_y, cfg.rect_cap, cfg.pair_budget)
    out = CompositeTiles.apply(stream, tile_starts, grid_x, grid_y,
                               cfg.tile_x, cfg.tile_y)
    maps = comp.unpack_tiles(out, h, w, grid_x, grid_y, cfg.tile_x,
                             cfg.tile_y)
    color = maps["rgb"] + maps["final_T"][None] * settings.bg[:, None, None]
    aux = {
        "final_T": maps["final_T"],
        "n_contrib": maps["n_contrib"],
        "n_visible": pk.n_visible,
        "n_pairs": n_pairs,
        "overflow_rect": pk.overflow_rect,
        "overflow_visible": pk.overflow_visible,
        "overflow_pairs": overflow_pairs,
        "visible": proj.visible,
    }
    return color, proj.radius, maps["depth"], aux
