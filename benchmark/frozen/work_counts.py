# Frozen copies, at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, of chip_smoke.py::work_counts and its
# instruction counts (chip_smoke.py:231-255), and of
# s3gaussian_tpu_torch/train_cli.py::auto_max_visible (cameras given as
# dicts of the clip's view).  The yardstick of the compositors' roofline
# and the reference's own sizing of the render budget.
"""What the compositors must do on a pair stream, and the render budget
that --max_visible 0 sizes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.ref.ops import composite as comp

# float32 operations per unit of work (chip_smoke.py:237-255): per
# (column, pair) a pixel of the column evaluates; per evaluated
# pixel-pair; forward / backward per contributing pixel-pair, and how many
# of those are FMAs, each counted as two operations; backward per
# (column, pair) a pixel of the column contributes to
COLUMN_OPS, ALPHA_OPS = 4, 10
FWD_BLEND_OPS, FWD_BLEND_FMAS = 9, 4
BWD_BLEND_OPS, BWD_BLEND_FMAS = 22, 12
BWD_COLUMN_OPS = 3


def column_groups(tile_x: int, tile_y: int, dev) -> dict:
    """[P] column of each pixel of a tile, the group the counts need."""
    return {"column": torch.arange(tile_x * tile_y, device=dev) % tile_x}


def work_counts(stream, tile_starts, gx, gy, tx, ty, groups,
                chunk=128):
    """What a compositor must do on this stream, counted as the plain
    version composites it: the pixel-pairs evaluated (a pixel evaluates
    its tile's pairs until the one that saturates it, inclusive), the
    pairs that must be read (per tile, the most any of its pixels
    evaluates) and, for each pixel-to-group map in ``groups`` ([P] group
    of each pixel: a warp, a column), the (group, pair)s in which some
    pixel evaluates and in which some pixel contributes.  The forward
    output's row 5 counts the contributing pixel-pairs."""
    dev = stream.device
    starts = tile_starts[:-1].long()
    counts = tile_starts[1:].long() - starts
    px, py = comp.tile_pixel_coords(gx, gy, tx, ty, dev)
    evaluated = torch.zeros(gx * gy, tx * ty, device=dev)
    onehot = {k: torch.nn.functional.one_hot(w).float()
              for k, w in groups.items()}
    group_pairs = {k: {"evaluating": 0, "contributing": 0} for k in groups}
    t = torch.ones(gx * gy, 1, tx * ty, device=dev)
    lane = torch.arange(chunk, device=dev)
    with torch.no_grad():
        for ci in range(-(-int(counts.max()) // chunk)):
            valid = (ci * chunk + lane)[None, :] < counts[:, None]
            idx = torch.where(valid, starts[:, None] + ci * chunk + lane, 0)
            f = stream[:, idx]
            dx = f[comp.FX][..., None] - px
            dy = f[comp.FY][..., None] - py
            power = (-0.5 * (f[comp.FCA][..., None] * dx * dx
                             + f[comp.FCC][..., None] * dy * dy)
                     - f[comp.FCB][..., None] * dx * dy)
            alpha = torch.clamp(f[comp.FOP][..., None] * torch.exp(power),
                                max=comp.ALPHA_MAX)
            am = torch.where((power > 0) | (alpha < comp.ALPHA_MIN)
                             | ~valid[..., None], 0.0, alpha)
            cum_incl = t * torch.cumprod(1.0 - am, dim=1)
            before = cum_incl / (1.0 - am)
            evals = (before >= comp.T_EPS) & valid[..., None]
            evaluated += evals.sum(1)
            contrib = (cum_incl >= comp.T_EPS) & (am > 0)
            for k, oh in onehot.items():
                for what, mask in (("evaluating", evals),
                                   ("contributing", contrib)):
                    group_pairs[k][what] += int(((mask.float() @ oh) > 0)
                                                .sum())
            t = cum_incl[:, -1:]
    return int(evaluated.sum()), int(evaluated.amax(1).sum()), group_pairs



def auto_max_visible(points, cams, capacity: int, growth: float = 2.0,
                     lane: int = 2048, group_by_frame: bool = False) -> int:
    """``--max_visible 0``: ``growth`` x the largest per-camera count of
    init points in the frustum (depth > 0.2, the projector's 1.3·tan(fov/2)
    clamp as its edge), lane-rounded and clamped to the pool capacity.
    With ``group_by_frame`` (rig steps) the count is that of the union
    of each frame's cameras, as one cull serves the whole rig."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    best = 0
    union = {}
    for cam in cams:
        view = np.asarray(cam["world_view"].cpu().numpy())
        p = pts @ view[:3, :3] + view[3, :3]
        z = p[:, 2]
        tx = 1.3 * np.tan(0.5 * cam["fovx"])
        ty = 1.3 * np.tan(0.5 * cam["fovy"])
        vis = (z > 0.2) & (np.abs(p[:, 0]) < tx * z) & (np.abs(p[:, 1]) < ty * z)
        if group_by_frame:
            k = int(cam["frame"])
            union[k] = vis if k not in union else union[k] | vis
        else:
            best = max(best, int(vis.sum()))
    if group_by_frame:
        best = max(int(v.sum()) for v in union.values())
    nr = int(np.ceil(growth * best / lane)) * lane
    return max(lane, min(nr, capacity))
