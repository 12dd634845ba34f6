"""Synthetic mini clip (port of the repository's ``scripts/mini_clip.py``):
a self-consistent street clip in the preprocessed Waymo layout
(calibration, ego poses, LiDAR, ground-truth images, dynamic masks,
``gt_motion.json``), rendered on the card from a known Gaussian scene by
the port's rasterizer, then, with ``--train``, reconstructed by the
port's training CLI with its evaluation sweep:

    python -m s3gaussian_tpu_torch.tools.mini_clip --out <clip dir> \\
        [--train] [--coarse 600 --fine 1500] [--h 640 --w 960]

Unknown flags pass through to the training CLI.  The images are PNG
content under the reader's ``.jpg`` names (``data/images.py::write_png``;
the readers decode by content), where the JAX script writes JPEGs.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.data.images import write_png
from s3gaussian_tpu_torch.data.waymo import OPENCV2DATASET, ORIGINAL_SIZE
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from s3gaussian_tpu_torch.ops.transforms import (focal2fov, full_projection,
                                                 projection_matrix)

CAM_YAWS = [0.0, 0.785, -0.785]
OVERFLOW_KEYS = ("overflow_rect", "overflow_visible", "overflow_pairs")


def gt_scene(rng, n_ground=48_000, n_build=32_000, n_car=6_000,
             density=1.0, car_mul=1.0, car_speed=1.0, car_size=1.0):
    """Street-like Gaussian scene in the world (= frame-0 ego) frame: x
    forward, y left, z up.  A checkered ground plane, building facades on
    both sides and three car clusters driving along x; per-Gaussian
    velocity (m per frame) and the cars' ground-truth motion boxes.

    ``car_mul``/``car_speed``/``car_size`` scale the cars' point count,
    velocity and extent (with their splat sigma); ``density`` scales every
    count by the factor and the splat sigma by 1/sqrt(density)."""
    n_ground = int(n_ground * density)
    n_build = int(n_build * density)
    n_car = int(n_car * density * car_mul)
    smul = float(density) ** -0.5
    # ground: textured plane z≈0 under the ego (cameras sit at z=2)
    gx = rng.uniform(-5, 120, n_ground)
    gy = rng.uniform(-12, 12, n_ground)
    gz = rng.normal(0.0, 0.02, n_ground)
    checker = ((np.floor(gx / 2) + np.floor(gy / 2)) % 2)
    g_col = np.stack([0.25 + 0.4 * checker,
                      0.25 + 0.3 * checker,
                      0.25 + 0.1 * checker], 1)
    g_scale = np.full((n_ground, 3), 0.14 * smul)
    g_scale[:, 2] = 0.02 * smul

    # "buildings": boxes of gaussians lining both sides
    bx = rng.uniform(0, 120, n_build)
    side = np.sign(rng.uniform(-1, 1, n_build))
    by = side * rng.uniform(13, 16, n_build)
    bz = rng.uniform(0, 8, n_build)
    hue = (np.floor(bx / 15) % 3)
    b_col = np.stack([0.3 + 0.2 * (hue == 0) + 0.25 * np.sin(bz / 3),
                      0.3 + 0.2 * (hue == 1) + 0.1 * np.cos(bx / 7),
                      0.3 + 0.2 * (hue == 2)], 1)
    b_col = np.clip(b_col, 0, 1)
    b_scale = np.full((n_build, 3), 0.16 * smul)

    # moving "cars": three clusters driving at different speeds
    car_cols = [(0.8, 0.1, 0.1), (0.1, 0.2, 0.8), (0.9, 0.8, 0.2)]
    car_vel = [(4.0 * car_speed, 0.0), (-3.0 * car_speed, 0.0),
               (5.0 * car_speed, 0.0)]              # m/frame in x,y
    n_per = n_car // 3
    vel = np.zeros((n_ground + n_build + n_per * 3, 3))
    pts_c, col_c = [], []
    for i, ((cx, cy), col) in enumerate(zip([(25, 4), (60, -4), (40, 0)],
                                            car_cols)):
        px = cx + rng.uniform(-2.2 * car_size, 2.2 * car_size, n_per)
        py = cy + rng.uniform(-1.0 * car_size, 1.0 * car_size, n_per)
        pz = 0.4 + rng.uniform(0, 1.4 * car_size, n_per)
        pts_c.append(np.stack([px, py, pz], 1))
        col_c.append(np.tile(np.asarray(col), (n_per, 1)))
        vel[n_ground + n_build + i * n_per:
            n_ground + n_build + (i + 1) * n_per, :2] = car_vel[i]
    c_scale = np.full((n_per * 3, 3), 0.12 * smul * car_size)

    pts = np.concatenate([np.stack([gx, gy, gz], 1),
                          np.stack([bx, by, bz], 1)] + pts_c, 0)
    cols = np.concatenate([g_col, b_col] + col_c, 0)
    scales = np.concatenate([g_scale, b_scale, c_scale], 0)
    n = len(pts)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full((n,), 0.9, np.float32)
    # ground-truth motion boxes for the flow EPE (eval/flow.py): each car
    # cluster is a rigid box translating at constant velocity; the
    # half-extents pad the sampling extents by 3 sigma of the splat scale
    boxes = [
        {"center0": [float(cx), float(cy), 0.4 + 0.7 * car_size],
         "vel": [float(vx), float(vy), 0.0],
         "half": [(2.2 + 0.4) * car_size, (1.0 + 0.4) * car_size,
                  (0.7 + 0.4) * car_size]}
        for (cx, cy), (vx, vy) in zip([(25, 4), (60, -4), (40, 0)], car_vel)]
    return dict(pts=pts.astype(np.float32), cols=cols.astype(np.float32),
                scales=scales.astype(np.float32), quats=quats,
                opac=opac, vel=vel.astype(np.float32), gt_boxes=boxes)


def write_clip(out: str, scene, n_frames: int, h: int, w: int, rng,
               ego_step: float = 2.0, lidar_cap: int = 30_000,
               budget_mul: int = 1, cfg: Optional[RasterConfig] = None,
               device: torch.device | str = "cuda"
               ) -> Tuple[Dict[str, int], int]:
    """Waymo-layout clip: calibration, poses, LiDAR rows sampled from the
    frame's Gaussian centres (column 6 the ground label), ground-truth
    images rendered on ``device`` from the known scene at the frame's
    displaced positions, dynamic masks, ``gt_motion.json`` and
    ``frame_info.json``.  ``cfg`` sets the renders' rasterizer (default:
    the JAX script's budgets times ``budget_mul``).  Returns the renders'
    overflow counts, summed, and the LiDAR rows written."""
    from preprocess.lidar_ground import ground_label

    device = configure_device(str(device))
    for d in ("images", "intrinsics", "extrinsics", "ego_pose", "lidar",
              "dynamic_masks"):
        os.makedirs(os.path.join(out, d), exist_ok=True)

    # calibration in ORIGINAL_SIZE scale (the reader rescales to load size)
    fx0, fy0 = 2080.0, 2080.0
    cx0, cy0 = ORIGINAL_SIZE[0][1] / 2, ORIGINAL_SIZE[0][0] / 2
    cam_to_egos = []
    for i, yaw in enumerate(CAM_YAWS):
        np.savetxt(os.path.join(out, "intrinsics", f"{i}.txt"),
                   np.array([fx0, fy0, cx0, cy0, 0, 0, 0, 0, 0]))
        c, s = np.cos(yaw), np.sin(yaw)
        c2e = np.array([[c, -s, 0, 1.5], [s, c, 0, 0.0],
                        [0, 0, 1, 2.0], [0, 0, 0, 1.0]])
        np.savetxt(os.path.join(out, "extrinsics", f"{i}.txt"), c2e)
        cam_to_egos.append(c2e @ OPENCV2DATASET)

    fx = fx0 * w / ORIGINAL_SIZE[0][1]
    fy = fy0 * h / ORIGINAL_SIZE[0][0]
    fovx, fovy = focal2fov(fx, w), focal2fov(fy, h)
    proj = projection_matrix(0.01, 100.0, fovx, fovy)
    if cfg is None:
        cfg = RasterConfig(max_visible=(1 << 16) * budget_mul, rect_w=6,
                           rect_h=6, pair_budget=(1 << 21) * budget_mul)

    def t_(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    scales, quats, opac, cols = (t_(scene[k]) for k in ("scales", "quats",
                                                        "opac", "cols"))
    moving = np.abs(scene["vel"]).sum(1) > 0
    overflow = dict.fromkeys(OVERFLOW_KEYS, 0)
    n_lidar = 0
    means0 = scene["pts"]
    for t in range(n_frames):
        ego = np.eye(4)
        ego[0, 3] = ego_step * t
        np.savetxt(os.path.join(out, "ego_pose", f"{t:03d}.txt"), ego)

        means_t = means0 + scene["vel"] * t
        # lidar: GT points in the ego_t frame (ego is axis-aligned shift)
        pts_ego = means_t - ego[:3, 3]
        keep = (pts_ego[:, 0] > -2) & (pts_ego[:, 0] < 80)
        sub = rng.choice(np.where(keep)[0],
                         min(lidar_cap, int(keep.sum())), replace=False)
        rows = np.zeros((len(sub), 10), np.float32)
        rows[:, 3:6] = pts_ego[sub]
        rows[:, 6] = ground_label(pts_ego[sub]).astype(np.float32)
        rows.tofile(os.path.join(out, "lidar", f"{t:03d}.bin"))
        n_lidar += len(sub)

        means = t_(means_t)
        for ci in range(len(CAM_YAWS)):
            c2w = ego @ cam_to_egos[ci]
            w2c = np.linalg.inv(c2w)
            settings = RasterSettings(
                h, w, float(np.tan(fovx / 2)), float(np.tan(fovy / 2)),
                torch.zeros(3, device=device), 1.0, t_(w2c.T),
                t_(full_projection(w2c, proj)), 0, t_(c2w[:3, 3]))
            with torch.no_grad():
                color, _, _, aux = rasterize(settings, means, opac,
                                             scales=scales, rotations=quats,
                                             colors_precomp=cols, cfg=cfg)
            for k in overflow:
                overflow[k] += int(aux[k])
            img = torch.clamp(color, 0, 1).permute(1, 2, 0).cpu().numpy()
            write_png(os.path.join(out, "images", f"{t:03d}_{ci}.jpg"),
                      (img * 255).astype(np.uint8), level=1)
            # dynamic mask: project moving points, dilate to blobs
            mask = np.zeros((h, w), np.uint8)
            pc = (w2c[:3, :3] @ means_t[moving].T + w2c[:3, 3:4])
            zc = pc[2]
            ok = zc > 0.2
            u = (fx * pc[0][ok] / zc[ok] + w / 2).astype(int)
            v = (fy * pc[1][ok] / zc[ok] + h / 2).astype(int)
            inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            for du in range(-4, 5):
                for dv in range(-4, 5):
                    uu = np.clip(u[inb] + du, 0, w - 1)
                    vv = np.clip(v[inb] + dv, 0, h - 1)
                    mask[vv, uu] = 255
            write_png(os.path.join(out, "dynamic_masks", f"{t:03d}_{ci}.png"),
                      mask, level=1)

    with open(os.path.join(out, "gt_motion.json"), "w") as f:
        json.dump({"frame_dt": 1.0, "n_frames": n_frames,
                   "boxes": scene["gt_boxes"]}, f, indent=2)
    with open(os.path.join(out, "frame_info.json"), "w") as f:
        json.dump({"frames": n_frames, "source": "mini_clip_synthetic"}, f)
    return overflow, n_lidar


def train_args(args, model_path):
    """Training-CLI argv for a generated clip, with density-aware budgets:
    the pool cap leaves ~2x densify headroom over the init count, the
    visible budget scales with the init count (at most 786,432) and the
    pair budget with the visible budget (4x4 rect clamp, at most 2^23).
    Explicit flags appended by the caller still win (argparse last-wins).
    The JAX script adds ``--remat_deform`` at density >= 2; the port has
    no such flag (ROADMAP.md, "Not ported")."""
    dmul = max(1.0, args.density)
    return [
        "-s", args.out, "--model_path", model_path,
        "--num_pts", str(int(120000 * args.density)),
        "--coarse_iterations", str(args.coarse),
        "--iterations", str(args.fine),
        "--densify_from_iter", "100",
        "--densify_until_iter", str(max(args.fine - 300, 200)),
        "--checkpoint_iterations", str(args.fine),
        "--stride", str(args.stride),
        "--opacity_reset_interval", str(args.reset_interval),
        "--load_h", str(args.h), "--load_w", str(args.w),
        "--max_points", str(max(500_000, min(int(250_000 * dmul),
                                             1_200_000))),
        "--max_visible", str(min(int((1 << 17) * dmul), 786_432)),
        "--rect_w", "4", "--rect_h", "4",
        "--pair_budget", str(min(int((1 << 22) * dmul), 1 << 23)),
    ]


def main(argv=None, device: str = "cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="/tmp/mini_clip")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--h", type=int, default=640)
    p.add_argument("--w", type=int, default=960)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train", action="store_true",
                   help="run the training CLI + eval after generation")
    p.add_argument("--coarse", type=int, default=600)
    p.add_argument("--fine", type=int, default=1500)
    p.add_argument("--stride", type=int, default=0)
    p.add_argument("--reset_interval", type=int, default=3000,
                   help="opacity_reset_interval; the post-reset 20-px "
                        "max-radius prune assumes real-scene point budgets "
                        "(1.5M init) - at mini-clip budgets a >3000-step run "
                        "prunes itself to collapse. Raise above --fine to "
                        "keep short synthetic runs out of that regime.")
    p.add_argument("--model_path", default="")
    p.add_argument("--density", type=float, default=1.0,
                   help="scale GT point counts by this and splat σ by "
                        "1/√density")
    p.add_argument("--car_mul", type=float, default=1.0,
                   help="multiply the dynamic (car) point count")
    p.add_argument("--car_speed", type=float, default=1.0,
                   help="multiply car velocities (m/frame)")
    p.add_argument("--car_size", type=float, default=1.0,
                   help="multiply car spatial extents and splat σ")
    # unknown flags pass through to the training CLI
    args, train_extra = p.parse_known_args(argv)

    rng = np.random.default_rng(args.seed)
    if not os.path.exists(os.path.join(args.out, "frame_info.json")):
        print(f"generating mini clip at {args.out} (density {args.density})")
        scene = gt_scene(rng, density=args.density, car_mul=args.car_mul,
                         car_speed=args.car_speed, car_size=args.car_size)
        write_clip(args.out, scene, args.frames, args.h, args.w, rng,
                   lidar_cap=int(30_000 * args.density),
                   budget_mul=max(1, int(np.ceil(args.density))),
                   device=device)
    else:
        print(f"clip exists at {args.out}")

    if args.train:
        from s3gaussian_tpu_torch import train_cli
        model_path = args.model_path or os.path.join(args.out, "recon")
        return train_cli.main(train_args(args, model_path) + train_extra,
                              device=device)
    return None


if __name__ == "__main__":
    main()
