"""Tile binning (port of ``s3gaussian_tpu/ops/binning.py``): visible
compaction, bounded pair-key emission, one stable key sort, tile ranges.

Keys are int64.  Below 4,095 tiles a key is
``(tile << 20) | (float_bits(depth) >> 12)`` — bit-equal to the JAX
package's uint32 key, invalid pairs included (``0xFFFFFFFF``).  From
4,095 tiles on it is ``(tile << 32) | float_bits(depth)``, the order of
JAX's two-key (tile, depth) sort; invalid pairs take tile ``0x7FFFFFFF``,
above every valid tile, and keep their depth bits so that they tie-break
exactly as JAX's invalid tile ``0xFFFFFFFF`` does.  ``torch.sort`` runs
with ``stable=True`` because ``lax.sort`` is stable.

Two-class emission (``big_budget > 0``) gives every render slot a 2×2
core and the first ``big_budget`` big Gaussians their periphery, in a
second section of the slot stream.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from s3gaussian_tpu_torch.ops.project import ProjectedGaussians

DEPTH_BITS = 20
INVALID_KEY = 0xFFFFFFFF              # single-key sentinel (JAX's uint32 max)
INVALID_TILE_TWO_KEY = 0x7FFFFFFF     # two-key sentinel tile


def two_key(n_tiles: int) -> bool:
    """True when tile ids do not fit the packed 12-bit tile field."""
    return n_tiles >= (1 << (32 - DEPTH_BITS)) - 1


class PairKeys(NamedTuple):
    sel: torch.Tensor              # [NR] int64 pool index of each render slot
    sel_visible: torch.Tensor      # [NR] bool render slot is a real visible gaussian
    keys: torch.Tensor             # [M] int64 unsorted pair keys (slot order)
    two_key: bool
    n_visible: torch.Tensor        # [] visible gaussians (pre NR-cap)
    overflow_rect: torch.Tensor    # [] gaussians whose rect was clamped
    overflow_visible: torch.Tensor  # [] visible gaussians beyond the NR budget
    # two-class emission only (None in single-class mode): slots
    # [0, 4·NR) are the 2×2 cores in render-slot order, slots
    # [4·NR, 4·NR + (rect_cap-4)·NB) the granted bigs' peripheries
    big_sel: Optional[torch.Tensor] = None      # [NB] pool ids of the bigs
    big_granted: Optional[torch.Tensor] = None  # [NR] slot got a periphery
    big_rank: Optional[torch.Tensor] = None     # [NR] periphery section index
    # [N] bool the pool visibility that ordered the compaction: the pair
    # stream's backward expands render slots back to pool rows by its rank
    visible: Optional[torch.Tensor] = None


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 bit pattern as a non-negative int64 (the uint32 value)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF


def depth_key_bits(depth: torch.Tensor) -> torch.Tensor:
    """Top DEPTH_BITS bits of the float32 depth — monotone for depth > 0."""
    return float_bits(depth) >> (32 - DEPTH_BITS)


def _quad_min_box(ca, cb, cc, bx0, bx1, by0, by1):
    """Exact minimum of ca·dx² + 2·cb·dx·dy + cc·dy² over the box
    [bx0,bx1]×[by0,by1]: 0 when the centre is inside, else the least of
    the four edges' clamped 1-D minima."""
    inside = (bx0 <= 0) & (0 <= bx1) & (by0 <= 0) & (0 <= by1)

    def qv(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def x_edge(dx):
        return qv(dx, torch.clamp(-cb * dx / cc, by0, by1))

    def y_edge(dy):
        return qv(torch.clamp(-cb * dy / ca, bx0, bx1), dy)

    edge_min = torch.minimum(torch.minimum(x_edge(bx0), x_edge(bx1)),
                             torch.minimum(y_edge(by0), y_edge(by1)))
    return torch.where(inside, torch.zeros_like(edge_min), edge_min)


def _ellipse_ok(ca, cb, cc, q_cut, xy, tx, ty, tile_x, tile_y):
    """True where the conic quadratic's minimum over the tile's pixel box
    reaches the alpha cutoff.  ca/cb/cc/q_cut [NS]; xy [NS,2]; tx/ty [NS,R]."""
    bx0 = (tx * tile_x).to(torch.float32) - xy[:, 0:1]
    by0 = (ty * tile_y).to(torch.float32) - xy[:, 1:2]
    qmin = _quad_min_box(ca[:, None], cb[:, None], cc[:, None],
                         bx0, bx0 + (tile_x - 1), by0, by0 + (tile_y - 1))
    return qmin <= q_cut[:, None]


@functools.lru_cache(maxsize=None)
def _peri_table(rect_w: int, rect_h: int) -> np.ndarray:
    """Periphery offsets of two-class emission: entry oy·(rect_w−1)+ox
    lists the rect_w×rect_h offsets outside the 2×2 core placed at
    (ox, oy), which always lies inside the centre-clamped big rect.
    Shape [(rect_w−1)·(rect_h−1), rect_cap−4, 2]."""
    rows = []
    for oy in range(rect_h - 1):
        for ox in range(rect_w - 1):
            rows.append([(dx, dy) for dy in range(rect_h)
                         for dx in range(rect_w)
                         if not (ox <= dx < ox + 2 and oy <= dy < oy + 2)])
    return np.asarray(rows, np.int32)


@functools.lru_cache(maxsize=None)
def _peri_table_on(rect_w: int, rect_h: int,
                   device: torch.device) -> torch.Tensor:
    """``_peri_table`` on ``device``, copied there once: a captured step
    may not copy from the host."""
    return torch.from_numpy(_peri_table(rect_w, rect_h)).to(device)


def make_pair_keys(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                   max_visible: int, rect_w: int, rect_h: int,
                   tile_x: int = 16, tile_y: int = 16,
                   opacities: Optional[torch.Tensor] = None,
                   big_budget: int = 0) -> PairKeys:
    """Visible compaction + pair-key emission (no sort).

    Single-class: each render slot emits up to rect_w×rect_h keys for the
    tiles its rect covers, oversized rects clamped around the projected
    centre (counted in ``overflow_rect``).  Two-class (``big_budget > 0``
    and a rect larger than 2×2): every slot emits its 2×2 centre-clamped
    core, and the first ``big_budget`` slots whose rect exceeds 2×2, in
    slot order, also emit the rest of their rect from a second section,
    M = 4·NR + (rect_cap−4)·NB; bigs beyond the budget keep their core
    only and are counted in ``overflow_rect``.  While the budget holds
    the valid pairs are those of single-class emission.  With
    ``opacities`` the exact ellipse–tile cut drops pairs whose alpha
    stays below 1/255 on the whole tile."""
    rect_cap = rect_w * rect_h
    dev = proj.depth.device
    use_two_key = two_key(grid_x * grid_y)
    n_pool = proj.depth.shape[0]
    nr = min(max_visible, n_pool)

    visible = proj.visible
    n_visible = visible.sum()
    if nr >= n_pool:
        sel = torch.arange(n_pool, device=dev)
        sel_visible = visible
        overflow_visible = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        order = torch.sort((~visible).to(torch.int32), stable=True).indices
        sel = order[:nr]
        sel_visible = visible[sel] & (torch.arange(nr, device=dev) < n_visible)
        overflow_visible = torch.clamp(n_visible - nr, min=0)

    rect = proj.tiles_rect[sel]
    xy = proj.xy[sel].detach()
    x0, y0, x1, y1 = rect.unbind(-1)
    w = x1 - x0
    h = y1 - y0
    overflow_rect = (((w > rect_w) | (h > rect_h)) & sel_visible).sum()

    # centre-clamp oversized rects (the tile of the projected mean stays in)
    cx = torch.clamp(torch.div(xy[:, 0], tile_x, rounding_mode="floor")
                     .to(torch.int32), x0, torch.maximum(x0, x1 - 1))
    cy = torch.clamp(torch.div(xy[:, 1], tile_y, rounding_mode="floor")
                     .to(torch.int32), y0, torch.maximum(y0, y1 - 1))
    wc = torch.clamp(w, max=rect_w)
    hc = torch.clamp(h, max=rect_h)
    x0c = torch.clamp(cx - rect_w // 2, x0, torch.maximum(x0, x1 - wc))
    y0c = torch.clamp(cy - rect_h // 2, y0, torch.maximum(y0, y1 - hc))

    cut = None
    if opacities is not None:
        op = opacities.detach().reshape(-1)
        op_s = op if nr >= n_pool else op[sel]
        q_cut = torch.clamp(2.0 * torch.log(torch.clamp(op_s, min=1e-9)
                                            * 255.0), min=0.0)
        con = proj.conic.detach()
        con = con if nr >= n_pool else con[sel]
        # dead/culled rows may carry garbage conics; they are invalid anyway
        cut = (torch.clamp(con[:, 0], min=1e-12), con[:, 1],
               torch.clamp(con[:, 2], min=1e-12), q_cut, xy)

    def emit(x0e, y0e, dx, dy, valid, rows=None):
        """Tiles at (x0e+dx, y0e+dy) [S, R], with the ellipse cut of the
        render slots ``rows`` (all slots when None)."""
        tx = x0e[:, None] + dx
        ty = y0e[:, None] + dy
        if cut is not None:
            c = cut if rows is None else [v[rows] for v in cut]
            valid = valid & _ellipse_ok(*c, tx, ty, tile_x, tile_y)
        return (ty * grid_x + tx).to(torch.int64), valid

    dfull = float_bits(proj.depth[sel].detach())
    extras = {}
    if big_budget <= 0 or rect_cap <= 4 or rect_w < 2 or rect_h < 2:
        r = torch.arange(rect_cap, dtype=torch.int32, device=dev)[None, :]
        dx, dy = r % rect_w, r // rect_w
        tile, valid = emit(x0c, y0c, dx, dy,
                           (dx < wc[:, None]) & (dy < hc[:, None])
                           & sel_visible[:, None])
        dslot = dfull[:, None].expand(nr, rect_cap)
    else:
        # the 2×2 core of every slot, centre-clamped inside its rect
        nb = min(big_budget, nr)
        ws = torch.clamp(w, max=2)
        hs = torch.clamp(h, max=2)
        x0s = torch.clamp(cx - 1, x0, torch.maximum(x0, x1 - ws))
        y0s = torch.clamp(cy - 1, y0, torch.maximum(y0, y1 - hs))
        rc = torch.arange(4, dtype=torch.int32, device=dev)[None, :]
        cdx, cdy = rc % 2, rc // 2
        core_tile, core_valid = emit(x0s, y0s, cdx, cdy,
                                     (cdx < ws[:, None]) & (cdy < hs[:, None])
                                     & sel_visible[:, None])
        # periphery sections for the first nb bigs, in slot order
        is_big = sel_visible & ((w > 2) | (h > 2))
        brank = torch.cumsum(is_big.to(torch.int32), 0,
                             dtype=torch.int32) - 1
        granted = is_big & (brank < nb)
        n_demoted = (is_big & ~granted).sum()
        bsl = torch.sort((~granted).to(torch.int32), stable=True).indices[:nb]
        bgranted = granted[bsl]         # masks the tail when < nb bigs
        table = _peri_table_on(rect_w, rect_h, dev)
        # the clip guards the non-granted tail, whose rects may be junk
        tidx = torch.clamp((y0s - y0c)[bsl] * (rect_w - 1)
                           + (x0s - x0c)[bsl], 0, table.shape[0] - 1).long()
        pdx, pdy = table[tidx].unbind(-1)           # [nb, rect_cap-4]
        peri_tile, peri_valid = emit(
            x0c[bsl], y0c[bsl], pdx, pdy,
            (pdx < wc[bsl][:, None]) & (pdy < hc[bsl][:, None])
            & bgranted[:, None], rows=bsl)
        tile = torch.cat([core_tile.reshape(-1), peri_tile.reshape(-1)])
        valid = torch.cat([core_valid.reshape(-1), peri_valid.reshape(-1)])
        dslot = torch.cat([dfull[:, None].expand(nr, 4).reshape(-1),
                           dfull[bsl][:, None].expand(nb, rect_cap - 4)
                           .reshape(-1)])
        overflow_rect = overflow_rect + n_demoted
        extras = {"big_sel": sel[bsl], "big_granted": granted,
                  "big_rank": brank}

    if use_two_key:
        tile = torch.where(valid, tile, INVALID_TILE_TWO_KEY)
        keys = (tile << 32) | dslot
    else:
        keys = torch.where(valid,
                           (tile << DEPTH_BITS) | (dslot >> (32 - DEPTH_BITS)),
                           INVALID_KEY)
    return PairKeys(sel=sel, sel_visible=sel_visible, keys=keys.reshape(-1),
                    two_key=use_two_key, n_visible=n_visible,
                    overflow_rect=overflow_rect,
                    overflow_visible=overflow_visible, visible=visible,
                    **extras)


def sort_pairs(pk: PairKeys):
    """One stable sort of the pair keys.  Returns (sorted_tile [M] int64,
    sorted_slot [M] int64 emission slot of each sorted pair)."""
    sorted_key, sorted_slot = torch.sort(pk.keys, stable=True)
    return sorted_key >> (32 if pk.two_key else DEPTH_BITS), sorted_slot


def tile_ranges(sorted_tile: torch.Tensor, n_tiles: int, bp: int):
    """Per-tile [start, end) ranges (``identifyTileRanges``) and budget
    accounting.  Returns (tile_starts [T+1] int32, n_pairs [], overflow_pairs [])."""
    tids = torch.arange(n_tiles + 1, dtype=sorted_tile.dtype,
                        device=sorted_tile.device)
    starts = torch.searchsorted(sorted_tile, tids, side="left")
    overflow_pairs = torch.clamp(starts[-1] - bp, min=0)
    starts = torch.clamp(starts, max=bp).to(torch.int32)
    return starts, starts[-1], overflow_pairs
