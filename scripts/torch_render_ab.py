#!/usr/bin/env python3
"""A/B of the PyTorch port's fine-stage render on one GPU.

Each TREE is a directory that holds an ``s3gaussian_tpu_torch`` package
(the repository root, or an unpacked ``git archive`` of another commit).
The trees run in the order given, each in its own process, on bench.py's
headline scene (200,000 Gaussians in a 204,800 pool, default deformation
field, 640x960, front camera at t = 0.4): 3 warm-up frames, then FRAMES
frames of the deformation field alone (CUDA events) and of ``render()``
(host clock around a synchronised call), without gradients.  One JSON
line per run; give each tree twice, in turns (A B B A), to see the noise:

    python3 scripts/torch_render_ab.py PARENT . . PARENT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FRAMES = 12


def worker(tree: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.ops.transforms import projection_matrix
    from s3gaussian_tpu_torch.render.renderer import render

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, cap = 200_000, 204_800
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
    view = np.eye(4, dtype=np.float32)
    full = (view @ projection_matrix(0.01, 100.0, 1.0, 1.0).T).astype(
        np.float32)
    cam = Camera(world_view=torch.tensor(view, device=dev),
                 full_proj=torch.tensor(full, device=dev),
                 campos=torch.zeros(3, device=dev),
                 time=torch.tensor(0.4, device=dev), fovx=1.0, fovy=1.0,
                 image_height=640, image_width=960)
    bg = torch.zeros(3, device=dev)
    deform_ms, frame_ms = [], []
    with torch.no_grad():
        for i in range(3 + FRAMES):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity,
                   pool.get_features(), cam.time.reshape(()), aabb)
            ev[1].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(cam, pool, deform, PipelineParams(), bg, aabb, 3,
                   stage="fine", cfg=cfg)
            torch.cuda.synchronize()
            if i >= 3:
                deform_ms.append(ev[0].elapsed_time(ev[1]))
                frame_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"tree": tree,
                      "deformation_ms": float(np.median(deform_ms)),
                      "frame_ms": float(np.median(frame_ms)),
                      "frames": FRAMES}), flush=True)


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
