"""Differentiable Gaussian rasterizer (port of
``s3gaussian_tpu/ops/rasterizer.py::rasterize``).

Dataflow, in three stages that ``chip_smoke.py`` also times one by one:

  ``project_and_pack``: covariance and projection (``project``) → SH
  colours → [16, N] feature rows (on the card the kernels of
  ``csrc/project.cu``); ``pair_keys`` on detached inputs (on the card
  one launch of ``csrc/bin_keys.cu`` after the compaction);
  ``bin_pairs``: ONE stable (key, slot) sort (32-bit keys below 4,095
  tiles) → tile ranges, the view's ``Binning``; ``gather_stream``: ONE
  gather of the 10 data rows at each sorted slot's column;
  ``tile_kernels.CompositeTiles``: the CUDA compositors, forward and
  backward (plain PyTorch on CPU tensors) → ``unpack_tiles`` →
  ``color = rgb + final_T·bg``.

A pass over the same projected geometry and alive mask as one already
binned (the feature pass beside its camera's RGB pass) takes that pass's
``Binning``: it projects and packs its own rows, differentiably, and
gathers them at the same slots; keys, sort and tile ranges run once.

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
The projection's and the SH colour's gradients are the kernels' backward
on the card (``ops/project.py``), autograd of the plain code on the CPU.

Inside a train step the three stages are marked (``utils/spans.py``):
``project.fwd``, ``bin.fwd`` and ``composite.fwd`` where each starts, and
their backward passes through identities on each stage's outputs: the
render's maps (``composite.bwd``), the pair stream (``bin.bwd``) and the
projection's outputs that the feature rows pack (``project.bwd``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.ops import composite as comp
from s3gaussian_tpu_torch.ops.binning import (PairKeys, make_pair_keys,
                                              sort_pairs, tile_ranges)
from s3gaussian_tpu_torch.ops.project import (ProjectedGaussians, project,
                                              project_gaussians, sh_to_color)
from s3gaussian_tpu_torch.ops.tile_kernels import CompositeTiles
from s3gaussian_tpu_torch.utils import spans


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


class Binning(NamedTuple):
    """A view's binning, detached: what the pair stream's gather and its
    backward read.  ``pk`` is the pair keys without their ``keys`` buffer
    (int32 below 4,095 tiles, int64 from there, ``ops/binning.py``; freed
    after the sort), ``n_slots`` the emitted slots M, ``slots`` [bp]
    int64 the emission slot of each sorted pair, cut to the pair budget;
    then the tile ranges [T+1] int32, ``n_pairs`` and
    ``overflow_pairs``.  A pass whose projection and alive mask equal the
    pass that binned can take it in place of its own."""

    pk: PairKeys
    n_slots: int
    slots: torch.Tensor
    tile_starts: torch.Tensor
    n_pairs: torch.Tensor
    overflow_pairs: torch.Tensor


def project_and_pack(settings: RasterSettings, means3d: torch.Tensor,
                     opacities: torch.Tensor,
                     scales: Optional[torch.Tensor] = None,
                     rotations: Optional[torch.Tensor] = None,
                     shs: Optional[torch.Tensor] = None,
                     colors_precomp: Optional[torch.Tensor] = None,
                     cov3d_precomp: Optional[torch.Tensor] = None,
                     alive: Optional[torch.Tensor] = None,
                     cfg: RasterConfig = RasterConfig(),
                     mean2d_tap: Optional[torch.Tensor] = None
                     ) -> tuple[ProjectedGaussians, torch.Tensor]:
    """Stage 1, differentiable: projection and colours, then (in
    ``bin.fwd``, which it opens) packed into the [16, N] feature rows.
    Returns (proj, feat_pool)."""
    kw = dict(tile_x=cfg.tile_x, tile_y=cfg.tile_y, mean2d_tap=mean2d_tap,
              alive=alive, opacities=opacities if cfg.tight_rect else None)
    cam = (settings.viewmatrix, settings.projmatrix, settings.tanfovx,
           settings.tanfovy, settings.image_width, settings.image_height)
    if cov3d_precomp is None:
        if settings.scale_modifier != 1.0:
            raise ValueError(f"scale_modifier {settings.scale_modifier}: "
                             f"the projection takes the scales as they are")
        proj = project(means3d, scales, rotations, *cam, **kw)
    else:
        proj = project_gaussians(means3d, cov3d_precomp, *cam, **kw)
    colors = (sh_to_color(shs, means3d, settings.campos, settings.sh_degree)
              if colors_precomp is None else colors_precomp)
    packed = spans.grad_mark("project.bwd", proj.xy, proj.conic, opacities,
                             colors, proj.depth)
    spans.mark("bin.fwd")
    return proj, comp.pack_pool_features(*packed)


def pair_keys(settings: RasterSettings, proj: ProjectedGaussians,
              opacities: torch.Tensor, cfg: RasterConfig) -> PairKeys:
    """The unsorted pair keys of a projection, on detached inputs."""
    grid_x, grid_y = grid_dims(settings, cfg)
    nr = min(cfg.max_visible, proj.depth.shape[0])
    nb = (min(cfg.big_budget, nr)
          if (cfg.big_budget > 0 and cfg.rect_cap > 4 and cfg.rect_w >= 2
              and cfg.rect_h >= 2) else 0)
    return make_pair_keys(
        ProjectedGaussians(*[x.detach() for x in proj]), grid_x, grid_y,
        cfg.max_visible, cfg.rect_w, cfg.rect_h, cfg.tile_x, cfg.tile_y,
        opacities=opacities.detach() if cfg.tight_rect else None,
        big_budget=nb)


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


def bin_pairs(pk: PairKeys, n_tiles: int, pair_budget: int) -> Binning:
    """Stage 2's binning: one stable (key, slot) sort, the sorted slots
    cut to the budget, tile ranges."""
    m = pk.keys.shape[0]
    bp = min(m, pair_budget)
    sorted_tile, sorted_slot = sort_pairs(pk)
    tile_starts, n_pairs, overflow_pairs = tile_ranges(sorted_tile, n_tiles,
                                                       bp)
    return Binning(pk._replace(keys=None), m, sorted_slot[:bp], tile_starts,
                   n_pairs, overflow_pairs)


def gather_stream(feat_pool: torch.Tensor, b: Binning,
                  rect_cap: int) -> torch.Tensor:
    """Stage 2's stream: ONE gather of the 10 data rows at the binning's
    sorted slots, beside the constant rows.  Returns [16, bp]."""
    rows = SortStreamGather.apply(feat_pool[:comp.N_DATA_ROWS], b.slots,
                                  b.n_pairs, b.pk, rect_cap, b.n_slots)
    const = torch.zeros(comp.PAIR_FEAT_DIM - comp.N_DATA_ROWS,
                        rows.shape[1], dtype=rows.dtype, device=rows.device)
    const[0] = 1.0                                   # the FONE channel
    return torch.cat([rows, const], 0).contiguous()


def rasterize(settings: RasterSettings, means3d: torch.Tensor,
              opacities: torch.Tensor,
              scales: Optional[torch.Tensor] = None,
              rotations: Optional[torch.Tensor] = None,
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              cov3d_precomp: Optional[torch.Tensor] = None,
              mean2d_tap: Optional[torch.Tensor] = None,
              alive: Optional[torch.Tensor] = None,
              cfg: RasterConfig = RasterConfig(),
              binning: Optional[Binning] = None):
    """Render one view from activated inputs.  Returns
    (color [3,H,W], radii [N], depth [H,W], aux); differentiable with
    respect to every float input and ``mean2d_tap``.  ``aux["binning"]``
    is the view's ``Binning``.  Given ``binning`` (that of a pass with
    the same projected geometry and alive mask), the call projects and
    packs its own rows and gathers them at its slots, with no keys, sort
    or tile ranges of its own."""
    h, w = settings.image_height, settings.image_width
    grid_x, grid_y = grid_dims(settings, cfg)
    spans.count(raster_passes=1, bins_reused=int(binning is not None))
    spans.mark("project.fwd")
    proj, feat_pool = project_and_pack(
        settings, means3d, opacities, scales, rotations, shs, colors_precomp,
        cov3d_precomp, alive, cfg, mean2d_tap)
    if binning is None:
        pk = pair_keys(settings, proj, opacities, cfg)
        spans.count(bins_kernel=int(pk.by_kernel))
        binning = bin_pairs(pk, grid_x * grid_y, cfg.pair_budget)
    stream = gather_stream(feat_pool, binning, cfg.rect_cap)
    (stream,) = spans.grad_mark("bin.bwd", stream)
    spans.mark("composite.fwd")
    out = CompositeTiles.apply(stream, binning.tile_starts, grid_x, grid_y,
                               cfg.tile_x, cfg.tile_y)
    maps = comp.unpack_tiles(out, h, w, grid_x, grid_y, cfg.tile_x,
                             cfg.tile_y)
    color = maps["rgb"] + maps["final_T"][None] * settings.bg[:, None, None]
    color, depth = spans.grad_mark("composite.bwd", color, maps["depth"])
    pk = binning.pk
    aux = {
        "final_T": maps["final_T"],
        "n_contrib": maps["n_contrib"],
        "n_visible": pk.n_visible,
        "n_pairs": binning.n_pairs,
        "overflow_rect": pk.overflow_rect,
        "overflow_visible": pk.overflow_visible,
        "overflow_pairs": binning.overflow_pairs,
        "visible": proj.visible,
        "binning": binning,
    }
    return color, proj.radius, depth, aux
