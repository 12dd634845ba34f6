"""The plain float32 reference of a training cell.

It is built from what the harness made from the seed (the cloud, its
colours, the views and their targets) and from nothing the program
made: it works out again the pool's initial scales (its own KNN), the
field's initial weights (the same seeded draws), the auto-sized render
budget, and then runs the first steps eagerly through the frozen copy of
the port's plain modules (``benchmark/frozen/ref``), with the plain
compositors and plain ordered sums, TF32 off.  ``tf32=True`` is the
control: the same with TF32 on for matmuls and convolutions.  ``fault``
plants one of the faults the comparison must catch in it:
``"half_batch"`` leaves out half of each rig's cameras and takes the mean
over the rest.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.frozen import compare
from benchmark.frozen import work_counts as wc
from benchmark.frozen.ref import config as rc
from benchmark.frozen.ref.data.cameras import Camera
from benchmark.frozen.ref.models.deformation import DeformationField
from benchmark.frozen.ref.models.pool import create_from_pcd
from benchmark.frozen.ref.ops import gridsample
from benchmark.frozen.ref.train import trainer


def settings(config: Dict):
    """(hp, opt, pipe, raster) of the frozen config classes."""
    return (rc.ModelHiddenParams(**config["model"]),
            rc.OptimizationParams(**config["optimization"]),
            rc.PipelineParams(), rc.RasterConfig(**config["raster"]))


def camera(view: Dict, clip_cfg: Dict, fovs) -> Camera:
    return Camera(world_view=view["world_view"], full_proj=view["full_proj"],
                  campos=view["campos"], time=view["time"], fovx=fovs[0],
                  fovy=fovs[1], image_height=clip_cfg["height"],
                  image_width=clip_cfg["width"], image=view["image"],
                  depth_map=view["depth_map"], feat_map=view["feat_map"],
                  dynamic_mask=view["dynamic_mask"], cam_idx=view["cam"],
                  frame_idx=view["frame"])


@contextlib.contextmanager
def precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def record_segment_sums(calls: Optional[List]):
    """Record (K, D, n_rows) of every ``segment_sum`` call into
    ``calls`` while the block runs (None: record nothing)."""
    if calls is None:
        yield
        return
    orig = gridsample.segment_sum

    def rec(keys, vals, n_rows):
        calls.append((int(keys.shape[0]), int(vals.shape[1]), int(n_rows)))
        return orig(keys, vals, n_rows)

    gridsample.segment_sum = rec
    try:
        yield
    finally:
        gridsample.segment_sum = orig


def initial_state(clip, config: Dict, seed: int, dev: torch.device):
    """The reference's start, from the seed's raw inputs."""
    hp, opt, pipe, cfg = settings(config)
    pool = create_from_pcd(clip.points.cpu().numpy(),
                           clip.colors.cpu().numpy(), config["capacity"],
                           config["sh_degree"], device=dev)
    field = DeformationField(hp, torch.Generator().manual_seed(
        int(seed) % (1 << 63)), dev)
    if cfg.max_visible == 0:
        from benchmark.harness.clip import fov
        fovs = fov(config["clip"])
        cams = [dict(v, fovx=fovs[0], fovy=fovs[1]) for u in clip.train_units
                for v in (clip.views[i] for i in u)]
        cfg.max_visible = wc.auto_max_visible(
            clip.points.cpu().numpy(), cams, config["capacity"],
            group_by_frame=config["multicam"] > 1)
    state = trainer.init_state(pool, field, clip.aabb)
    return state, (hp, opt, pipe, cfg)


def run_steps(clip, config: Dict, seed: int, units: Sequence[Sequence[int]],
              dev: torch.device, tf32: bool = False,
              fault: Optional[str] = None,
              segment_sums: Optional[List] = None) -> Dict:
    """The reference's first ``len(units)`` steps: {"losses", "grad",
    "delta", "max_visible"}; ``segment_sums`` receives the first step's
    ``segment_sum`` calls."""
    from benchmark.harness.clip import fov
    state, (hp, opt, pipe, cfg) = initial_state(clip, config, seed, dev)
    fovs = fov(config["clip"])
    bg = torch.zeros(3, device=dev)
    common = (config["stage"], config["sh_degree"], hp, opt, pipe, cfg,
              clip.spatial_lr_scale, bg)
    tree = compare.leaves(state.pool.param_dict(),
                          state.deform.named_parameters())
    start = {k: v.detach().clone() for k, v in tree.items()}
    out = {"losses": [], "max_visible": cfg.max_visible}
    with precision(tf32):
        for i, unit in enumerate(units):
            cams = [camera(clip.views[j], config["clip"], fovs)
                    for j in unit]
            if fault == "half_batch":
                cams = cams[:len(cams) - len(cams) // 2]
            with record_segment_sums(segment_sums if i == 0 else None):
                if config["multicam"] > 1:
                    state, aux = trainer.train_step_multicam(state, cams,
                                                             *common)
                else:
                    state, aux = trainer.train_step(state, cams[0], *common)
            out["losses"].append(float(aux["metrics"]["loss"]))
            if i == 0:
                out["grad"] = compare.first_grad_norms(compare.leaves(
                    state.adam.mu["pool"], state.adam.mu["deform"].items()))
    after = compare.leaves(state.pool.param_dict(),
                           state.deform.named_parameters())
    out["delta"] = compare.change_norms(start, after)
    return out
