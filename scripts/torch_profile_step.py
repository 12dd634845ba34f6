#!/usr/bin/env python3
"""Kernel-level profile of the PyTorch port's fine train step on one GPU.

Workloads (``--workload``, default ``single``):

  single     ``chip_smoke.py``'s training slice: bench.py's headline scene
             (200,000 Gaussians in a 204,800 pool, default deformation
             field, 640x960, random RGB and LiDAR-depth targets), one
             camera a step (``train_step``);
  rig        the same scene, a rig of 3 cameras yawed -40/0/+40 degrees
             a step (``train_step_multicam``; chip_smoke.py phase 5b);
  waymo_rig  bench.py's detail_waymo_rig: the street360 cloud of 1.5 M
             points in a 1,507,328 pool, the 3-camera rig, the union cull
             to 589,824 rows, two-class emission (big_budget 131,072),
             pair budget 2^23 (chip_smoke.py phase 6c).

It takes 3 warm-up fine steps, then traces STEPS fine steps with
``torch.profiler`` and prints, as JSON lines: the step's wall time (host
clock, synchronised), the device kernel time per step and its share of
the step (the busy share), the launches per step, and the TOP kernels by
device time per step.  With ``--graph`` the steps are replays of the
step captured as a CUDA graph (``train_steps_scan[_multicam]``, blocks
of STEPS, the capture in the warm-up) instead of eager steps.  Run from
the repository root:

    python3 scripts/torch_profile_step.py [--workload rig] [--graph]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STEPS, TOP = 4, 15


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from s3gaussian_tpu_torch.bench import card_line
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train import trainer as tr

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", default="single",
                        choices=("single", "rig", "waymo_rig"))
    parser.add_argument("--graph", action="store_true",
                        help="replays of the captured step")
    cli = parser.parse_args()
    workload = cli.workload
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = configure_device("cuda")
    if workload == "waymo_rig":
        pts, cols, rng = cs.street360(cs.WAYMO_N)
        pool = create_from_pcd(pts, cols, cs.WAYMO_CAP, device=dev)
        cfg = RasterConfig(tile_x=16, tile_y=16,
                           max_visible=cs.WAYMO_MAX_VISIBLE, rect_w=4,
                           rect_h=4, pair_budget=cs.WAYMO_PAIR_BUDGET,
                           big_budget=cs.WAYMO_BIG_BUDGET,
                           cull_before_deform=True)
    else:
        pool, rng = cs.make_scene(torch, dev, cs.N_GAUSSIANS, cs.CAPACITY)
        cfg = RasterConfig(tile_x=16, tile_y=16, max_visible=cs.CAPACITY,
                           rect_w=4, rect_h=4, pair_budget=1 << 22)
    gt = rng.random((cs.H, cs.W, 3)).astype(np.float32)
    gt_depth = rng.uniform(1, 70, (cs.H, cs.W)).astype(np.float32)
    hp, opt, pipe = ModelHiddenParams(), OptimizationParams(), PipelineParams()
    deform = DeformationField(hp, torch.Generator().manual_seed(0), dev)
    aabb = torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                        device=dev)
    bg = torch.zeros(3, device=dev)
    state = tr.init_state(pool, deform, aabb)
    yaws = (0.0,) if workload == "single" else cs.YAWS_DEG
    cams = [[cs.rig_camera(torch, dev, yaw, 0.4 + 1e-4 * i, cs.H, cs.W, gt,
                           gt_depth) for yaw in yaws]
            for i in range(3 + STEPS)]

    args = ("fine", 3, hp, opt, pipe, cfg, cs.SPATIAL_LR_SCALE, bg)

    def steps(s, rigs):
        if cli.graph and workload == "single":
            return tr.train_steps_scan(s, [r[0] for r in rigs], *args)[0]
        if cli.graph:
            return tr.train_steps_scan_multicam(s, rigs, len(yaws),
                                                *args)[0]
        for rig in rigs:
            s = (tr.train_step(s, rig[0], *args) if workload == "single"
                 else tr.train_step_multicam(s, rig, *args))[0]
        return s

    state = steps(state, cams[:3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = steps(state, cams[3:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.device_time_total / 1e3
        d[1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / STEPS
    print(json.dumps({"card": card_line(), "workload": workload,
                      "graph": cli.graph,
                      "cameras_per_step": len(yaws), "steps": STEPS,
                      "step_wall_ms": wall_ms,
                      "device_kernel_ms_per_step": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "launches_per_step": len(kernels) / STEPS}))
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:TOP]:
        print(json.dumps({"kernel": name[:120], "ms_per_step": ms / STEPS,
                          "launches_per_step": n / STEPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
