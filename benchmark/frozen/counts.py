"""Work counts of a traced window, from the program's end state through
the frozen plain renderer: each compositor pass of a sample of the
window's steps (its pair stream recorded where the plain compositor
takes it, then ``work_counts``), and the rows in the cameras' frusta.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.frozen import flops
from benchmark.frozen import work_counts as wc
from benchmark.frozen.ref.models.deformation import DeformationField
from benchmark.frozen.ref.models.pool import GaussianPool
from benchmark.frozen.ref.ops import rasterizer
from benchmark.frozen.ref.render import renderer


def _frozen_model(state, hp_ref, dev):
    """The frozen modules holding the program state's tensors."""
    pool = GaussianPool(**{k: getattr(state.pool, k) for k in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation",
        "opacity", "alive")})
    field = DeformationField(hp_ref, torch.Generator().manual_seed(0), dev)
    field.load_state_dict(state.deform.state_dict())
    return pool, field


def sample_calls(clip, config: Dict, state, cfg, units: Sequence[int]
                 ) -> List[Dict]:
    """Per compositor pass of the sample's steps: n_pairs, the forward
    and backward operations, and the backward's least time."""
    from benchmark.frozen import reference
    from benchmark.harness.clip import fov
    hp_ref, _, pipe, cfg_ref = reference.settings(config)
    cfg_ref.max_visible = cfg.max_visible
    dev = state.pool.xyz.device
    pool, field = _frozen_model(state, hp_ref, dev)
    fovs = fov(config["clip"])
    bg = torch.zeros(3, device=dev)
    streams: List = []
    orig = rasterizer.CompositeTiles

    class Recorded(orig):
        @staticmethod
        def forward(ctx, pair_feat, tile_starts, gx, gy, tx, ty):
            out = orig.forward(ctx, pair_feat, tile_starts, gx, gy, tx, ty)
            streams.append((pair_feat, tile_starts, out, (gx, gy, tx, ty)))
            return out

    rasterizer.CompositeTiles = Recorded
    calls = []
    try:
        with torch.no_grad():
            for u in units:
                cams = [reference.camera(clip.views[i], config["clip"], fovs)
                        for i in clip.train_units[u]]
                kw = dict(stage=config["stage"], render_feat=True, cfg=cfg_ref)
                if config["multicam"] > 1:
                    renderer.render_multicam(cams, pool, field, pipe, bg,
                                             clip.aabb, config["sh_degree"],
                                             **kw)
                else:
                    renderer.render(cams[0], pool, field, pipe, bg, clip.aabb,
                                    config["sh_degree"], **kw)
                while streams:
                    calls.append(_count(*streams.pop(0)))
    finally:
        rasterizer.CompositeTiles = orig
    return calls


def _count(stream, tile_starts, out, dims) -> Dict:
    gx, gy, tx, ty = dims
    evaluated, needed, groups = wc.work_counts(
        stream, tile_starts, gx, gy, tx, ty,
        wc.column_groups(tx, ty, stream.device))
    c = {"evaluated": evaluated, "needed": needed,
         "contributing": int(out[:, 5].sum()),
         "column_evaluating": groups["column"]["evaluating"],
         "column_contributing": groups["column"]["contributing"],
         "n_pairs": int(tile_starts[-1])}
    n_tiles, pixels = gx * gy, tx * ty
    c["fwd_ops"] = flops.compositor(c, False)
    c["bwd_ops"] = flops.compositor(c, True)
    c["bwd_least_s"] = flops.least_s(c["bwd_ops"], flops.compositor_bytes(
        c, n_tiles, pixels, stream.shape[1], True))
    c["fwd_least_s"] = flops.least_s(c["fwd_ops"], flops.compositor_bytes(
        c, n_tiles, pixels, stream.shape[1], False))
    return c


def frustum_rows(clip, config: Dict, units: Sequence[int]) -> Dict:
    """Mean over ``units`` of the alive init rows in each camera's
    frustum and in each rig's union (``auto_max_visible``'s test: depth
    over 0.2, within 1.3 tan(fov/2))."""
    from benchmark.harness.clip import fov
    fovx, fovy = fov(config["clip"])
    tx, ty = 1.3 * torch.tan(torch.tensor(0.5 * fovx)), 1.3 * torch.tan(
        torch.tensor(0.5 * fovy))
    pts = clip.points
    views, unions = [], []
    for u in units:
        union = None
        for i in clip.train_units[u]:
            v = clip.views[i]["world_view"]
            p = pts @ v[:3, :3] + v[3, :3]
            z = p[:, 2]
            vis = ((z > 0.2) & (p[:, 0].abs() < tx * z)
                   & (p[:, 1].abs() < ty * z))
            views.append(int(vis.sum()))
            union = vis if union is None else union | vis
        unions.append(int(union.sum()))
    return {"view_mean": sum(views) / len(views),
            "rig_union_mean": sum(unions) / len(unions)}
