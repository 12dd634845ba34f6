#!/usr/bin/env python3
"""A/B of the PyTorch port's evaluation sweep (``eval/video.py``) on one
GPU.

Each TREE is a directory that holds an ``s3gaussian_tpu_torch`` package
(the repository root, or an unpacked ``git archive`` of another commit).
The trees run in the order given, each in its own process, on bench.py's
headline scene (200,000 Gaussians in a 204,800 pool, default deformation
field) seen by a split laid out as the Waymo layout's: 10 rigs of 3
cameras (yaw -45/0/+45 degrees, one time a rig) at 640x960, each with a
random ground-truth image and a dynamic mask, LPIPS from the committed
fixture weights.  The split is swept twice by ``render_pixels`` (the
first time with the trees' one-off costs: on the card a capture), then
written by ``save_videos`` (PNGs where imageio has no mp4 backend).  One
JSON line per run: seconds of each sweep, of the writing, and the views a
second of the second sweep.  Give each tree twice, in turns (A B B A):

    python3 scripts/torch_sweep_ab.py PARENT . . PARENT
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

RIGS, YAWS = 10, (-45.0, 0.0, 45.0)


def worker(tree: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.eval.video import render_pixels, save_videos
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.ops.transforms import projection_matrix

    os.environ["S3G_LPIPS_WEIGHTS"] = os.path.join(
        tree, "tests", "fixtures", "lpips_alex_fixture.npz")
    dev = configure_device("cuda")
    rng = np.random.default_rng(0)
    n, cap, h, w = 200_000, 204_800, 640, 960
    tan = np.tan(0.5)
    z = rng.uniform(1.0, 60.0, n)
    pts = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                    rng.uniform(-0.9, 0.9, n) * tan * z, z],
                   1).astype(np.float32)
    pool = create_from_pcd(pts, rng.random((n, 3)).astype(np.float32), cap,
                           device=dev)
    hp = ModelHiddenParams()
    deform = DeformationField(hp, torch.Generator().manual_seed(0), dev)
    aabb = torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                        device=dev)
    cfg = RasterConfig(tile_x=16, tile_y=16, max_visible=cap, rect_w=4,
                       rect_h=4, pair_budget=1 << 22)
    proj = projection_matrix(0.01, 100.0, 1.0, 1.0).T
    cams = []
    for r in range(RIGS):
        for yaw in YAWS:
            a = np.deg2rad(yaw)
            rot = np.array([[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
                            [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]],
                           np.float32)
            mask = np.zeros((h, w), bool)
            y0, x0 = rng.integers(0, h - 200), rng.integers(0, w - 300)
            mask[y0:y0 + 200, x0:x0 + 300] = True
            cams.append(Camera(
                world_view=torch.tensor(rot, device=dev),
                full_proj=torch.tensor((rot @ proj).astype(np.float32),
                                       device=dev),
                campos=torch.zeros(3, device=dev),
                time=torch.tensor(r / RIGS, device=dev), fovx=1.0, fovy=1.0,
                image_height=h, image_width=w,
                image=torch.tensor(rng.random((h, w, 3)).astype(np.float32),
                                   device=dev),
                dynamic_mask=torch.tensor(mask, device=dev)))
    bg = torch.zeros(3, device=dev)
    sweep_s = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = render_pixels(cams, pool, deform, PipelineParams(), bg,
                                   aabb, 3, "fine", cfg)
            torch.cuda.synchronize()
            sweep_s.append(time.perf_counter() - t0)
    out = os.path.join(tree, "build", "sweep_ab_videos")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    save_videos(frames, out, num_timestamps=RIGS)
    video_s = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"tree": tree, "views": len(cams),
                      "sweep_s": [round(x, 4) for x in sweep_s],
                      "views_per_s": round(len(cams) / sweep_s[1], 3),
                      "writing_s": round(video_s, 4),
                      "psnr": frames["metrics"]["psnr"],
                      "lpips": frames["metrics"]["lpips"]}), flush=True)


def main(trees) -> int:
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", os.path.abspath(tree)], env=env,
                              timeout=600)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
