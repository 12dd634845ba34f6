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
gather stays differentiable: its backward sums the per-pair gradients of
the backward compositor into the render set and the pool, which replaces
the JAX package's un-sort and rect-axis reshape-sum (a TPU layout
choice).  With two-class emission the columns are the render set
followed by the granted bigs (``PairKeys.big_sel``), so the gather's
backward also sums each periphery's gradients into its pool row, where
JAX adds them through ``big_rank``.  Slots past ``n_pairs`` get zero
gradient from the kernel.
Every other gradient (EWA projection, covariance, SH) is autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.ops import composite as comp
from s3gaussian_tpu_torch.ops.binning import (PairKeys, make_pair_keys,
                                              sort_pairs, tile_ranges)
from s3gaussian_tpu_torch.ops.project import (ProjectedGaussians, build_cov3d,
                                              project_gaussians, sh_to_color)
from s3gaussian_tpu_torch.ops.tile_kernels import CompositeTiles


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


def sort_stream(feat_pool: torch.Tensor, pk: PairKeys, n_tiles: int,
                rect_cap: int, pair_budget: int):
    """Stage 2: one stable (key, slot) sort, one gather of the 10 data rows
    at the sorted, budget-truncated positions, tile ranges.
    Returns (stream [16, bp], tile_starts [T+1] int32, n_pairs, overflow_pairs)."""
    m = pk.keys.shape[0]
    bp = min(m, pair_budget)
    sorted_tile, sorted_slot = sort_pairs(pk)
    pool_rows = feat_pool[:comp.N_DATA_ROWS]
    nr = pk.sel.shape[0]
    data = pool_rows if nr >= feat_pool.shape[1] else pool_rows[:, pk.sel]
    slots = sorted_slot[:bp]
    if pk.big_sel is None:
        gid = slots // rect_cap
    else:
        # two sections: cores at stride 4, then the bigs' peripheries
        data = torch.cat([data, pool_rows[:, pk.big_sel]], 1)
        m1 = 4 * nr
        gid = torch.where(slots < m1, slots // 4,
                          nr + (slots - m1) // (rect_cap - 4))
    rows = data[:, gid]
    const = torch.zeros(comp.PAIR_FEAT_DIM - comp.N_DATA_ROWS, bp,
                        dtype=rows.dtype, device=rows.device)
    const[0] = 1.0                                   # the FONE channel
    stream = torch.cat([rows, const], 0).contiguous()
    tile_starts, n_pairs, overflow_pairs = tile_ranges(sorted_tile, n_tiles,
                                                       bp)
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
