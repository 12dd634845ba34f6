"""The traffic generator: a Waymo-layout clip made on the device from the
seed, and the order in which a run's steps draw its views.

The scene is ``street360`` of ``s3gaussian_tpu_torch/bench.py::cloud``
(commit 0fe8bd83), a LiDAR-like ring around the ego (radius 2-60 m,
height -1.5-6 m) with uniform colours, drawn here with a
``torch.Generator`` on the device.  The rig is ``bench.py::rig_view``'s
yawed rig: camera b of a frame at yaw (b - (B-1)/2) x ``yaw_deg``, all at
the ego's centre, which advances ``ego_step_m`` a frame along +z.  Each
view carries what ``tools/mini_clip.py::write_clip`` gives a view, drawn
on the device: an RGB image, a sparse LiDAR depth map (the cloud
projected into the view, nearest point a pixel, 0 elsewhere), a [H,W,3]
feature map standing in for the PCA'd DINO features, and a dynamic mask
(seeded boxes).  Nothing is read from disk.

Everything here is plain PyTorch and NumPy: the program and the
reference are handed the same tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch

from benchmark.frozen.ref.ops.transforms import projection_matrix


@dataclass
class Clip:
    points: torch.Tensor        # [n, 3] float32, on the device
    colors: torch.Tensor        # [n, 3] float32 in [0, 1)
    views: List[Dict]           # per view: tensors and ints (see view())
    train_units: List[List[int]]  # the views a step takes: 1 or a rig
    time_of_frame: List[float]
    spatial_lr_scale: float
    aabb: torch.Tensor          # [2, 3] (max; min)


def _seed64(seed: int, salt: int) -> int:
    return (int(seed) * 1_000_003 + salt) % (1 << 63)


def street360(n: int, gen: torch.Generator, dev) -> tuple:
    """bench.py's street360 cloud on the device: points and colours."""
    u = torch.rand((n, 3), generator=gen, device=dev)
    ang = u[:, 0] * (2 * math.pi)
    rad = 2.0 + 58.0 * u[:, 1]
    y = -1.5 + 7.5 * u[:, 2]
    pts = torch.stack([rad * torch.sin(ang), y, rad * torch.cos(ang)], 1)
    return pts.contiguous(), torch.rand((n, 3), generator=gen, device=dev)


def rig_matrices(frame: int, cam: int, clip: Dict) -> tuple:
    """(world_view, full_proj, campos) of camera ``cam`` at ``frame``, as
    numpy float32 row-vector transforms (bench.py's yawed rig)."""
    n_cams = clip["cameras"]
    yaw = (cam - (n_cams - 1) / 2) * np.deg2rad(clip["yaw_deg"])
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    centre = np.array([0.0, 0.0, clip["ego_step_m"] * frame], np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[3, :3] = -centre @ rot
    fovx, fovy = fov(clip)
    proj = projection_matrix(clip["znear"], clip["zfar"], fovx, fovy)
    return view, (view @ proj.T).astype(np.float32), centre


def fov(clip: Dict) -> tuple:
    """(fovx, fovy): fovy from fovx and the image's aspect."""
    fovx = clip["fovx"]
    return fovx, 2 * math.atan(math.tan(fovx / 2) * clip["height"]
                               / clip["width"])


def lidar_depth(points: torch.Tensor, view: torch.Tensor, clip: Dict
                ) -> torch.Tensor:
    """[H, W] float32: the nearest point's depth in each pixel the cloud
    hits in front of the camera, 0 elsewhere."""
    h, w = clip["height"], clip["width"]
    fovx, fovy = fov(clip)
    p = points @ view[:3, :3] + view[3, :3]
    z = p[:, 2]
    fx = w / (2 * math.tan(fovx / 2))
    fy = h / (2 * math.tan(fovy / 2))
    u = torch.floor(p[:, 0] / z.clamp(min=1e-6) * fx + w / 2)
    v = torch.floor(p[:, 1] / z.clamp(min=1e-6) * fy + h / 2)
    ok = (z > clip["znear"]) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    idx = (v[ok] * w + u[ok]).to(torch.int64)
    depth = torch.full((h * w,), math.inf, device=points.device)
    depth.scatter_reduce_(0, idx, z[ok], "amin")
    return torch.where(torch.isinf(depth), 0.0, depth).reshape(h, w)


def dynamic_mask(gen: torch.Generator, clip: Dict, dev) -> torch.Tensor:
    """[H, W] bool: ``mask_boxes`` boxes of seeded place and size."""
    h, w = clip["height"], clip["width"]
    b = torch.rand((clip["mask_boxes"], 4), generator=gen, device=dev)
    rows = torch.arange(h, device=dev)[:, None, None]
    cols = torch.arange(w, device=dev)[None, :, None]
    r0, c0 = b[:, 0] * h * 0.8, b[:, 1] * w * 0.8
    r1, c1 = r0 + (0.05 + 0.15 * b[:, 2]) * h, c0 + (0.05 + 0.15 * b[:, 3]) * w
    inside = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    return inside.any(-1)


def nerf_norm_radius(centres: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre from their mean
    (the reference's ``getNerfppNorm``)."""
    centre = centres.mean(0, keepdims=True)
    return float(np.linalg.norm(centres - centre, axis=1).max() * 1.1)


def make_clip(config: Dict, seed: int, dev: torch.device) -> Clip:
    """The configuration's clip, made from ``seed`` on ``dev``."""
    c = config["clip"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed64(seed, 0))
    points, colors = street360(config["num_pts"], gen, dev)
    n_frames, n_cams = c["frames"], c["cameras"]
    h, w = c["height"], c["width"]
    views, train_units, centres = [], [], []
    times = [f / c["time_denominator"] for f in range(n_frames)]
    for f in range(n_frames):
        for b in range(n_cams):
            view, full, campos = rig_matrices(f, b, c)
            wv = torch.as_tensor(view, device=dev)
            views.append({
                "world_view": wv, "full_proj": torch.as_tensor(full, device=dev),
                "campos": torch.as_tensor(campos, device=dev),
                "time": torch.tensor(times[f], dtype=torch.float32,
                                     device=dev),
                "image": torch.rand((h, w, 3), generator=gen, device=dev),
                "depth_map": lidar_depth(points, wv, c),
                "feat_map": torch.rand((h, w, 3), generator=gen, device=dev),
                "dynamic_mask": dynamic_mask(gen, c, dev),
                "frame": f, "cam": b})
        stride = c["stride"]
        if stride == 0 or f % stride != 0 or f == 0:
            ids = [f * n_cams + b for b in range(n_cams)]
            train_units += [ids] if config["multicam"] > 1 else [[i]
                                                                for i in ids]
            centres += [views[i]["campos"].cpu().numpy() for i in ids]
    aabb = torch.tensor(config["aabb"], dtype=torch.float32, device=dev)
    return Clip(points, colors, views, train_units, times,
                nerf_norm_radius(np.stack(centres)), aabb)


def unit_order(n_units: int, seed: int) -> Iterator[int]:
    """The train units of the steps, in order: one seeded permutation of
    all units after another, so every seed trains the same set and the
    first ``n_units`` steps never repeat a unit."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    while True:
        yield from (int(i) for i in rng.permutation(n_units))
