"""Scene assembly and dataset dispatch (port of
``s3gaussian_tpu/data/scene.py``).

The dataset type is told by a marker file (``frame_info.json`` -> Waymo,
``sparse/`` -> COLMAP, ``transforms_train.json`` -> Blender).  The pool is
initialised from the scene's point cloud with capacity
``min(max(next_pow2(1.5 n), 2^16), 2^21)`` unless the caller gives one,
and the frustum aabb is stored as [max; min] for the hexplane (the
reference's ``set_aabb(max, min)`` quirk).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from s3gaussian_tpu_torch.config import ModelParams
from s3gaussian_tpu_torch.data.waymo import SceneInfo, read_waymo
from s3gaussian_tpu_torch.models.pool import GaussianPool, create_from_pcd


@dataclass
class Scene:
    info: SceneInfo
    pool: GaussianPool
    cameras_extent: float
    aabb: torch.Tensor           # [2,3] as [max; min] for the hexplane
    model_path: str = ""

    def get_train_cameras(self):
        return self.info.train_cameras

    def get_test_cameras(self):
        return self.info.test_cameras

    def get_full_cameras(self):
        return self.info.full_cameras


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def load_scene(args: ModelParams, pool_capacity: Optional[int] = None,
               max_sh_degree: int = 3,
               device: torch.device | str = "cuda") -> Scene:
    src = args.source_path
    if os.path.exists(os.path.join(src, "frame_info.json")):
        info = read_waymo(
            src, white_background=args.white_background, eval_=args.eval,
            load_sky_mask=args.load_sky_mask,
            load_dynamic_mask=args.load_dynamic_mask,
            load_panoptic_mask=args.load_panoptic_mask,
            load_sam_mask=args.load_sam_mask,
            load_feat_map=args.load_feat_map, start_time=args.start_time,
            end_time=args.end_time,
            original_start_time=args.original_start_time,
            num_pts=args.num_pts, stride=args.stride,
            save_occ_grid=args.save_occ_grid,
            occ_voxel_size=args.occ_voxel_size,
            recompute_occ_grid=args.recompute_occ_grid,
            load_size=(args.load_h, args.load_w), device=device)
    elif os.path.exists(os.path.join(src, "sparse")):
        from s3gaussian_tpu_torch.data.colmap import read_colmap_scene
        info = read_colmap_scene(src, args.images, args.eval, device=device)
    elif os.path.exists(os.path.join(src, "transforms_train.json")):
        from s3gaussian_tpu_torch.data.blender import read_blender_scene
        info = read_blender_scene(src, args.white_background, args.eval,
                                  device=device)
    else:
        raise ValueError(f"Could not recognize scene type for {src}")

    n = len(info.points)
    if pool_capacity is None:
        # headroom for densification, capped at the reference's 2M limit
        pool_capacity = min(max(next_pow2(int(n * 1.5)), 1 << 16), 1 << 21)
    pool = create_from_pcd(info.points, info.colors, pool_capacity,
                           max_sh_degree, device=device)
    aabb = torch.as_tensor(np.stack([info.aabb[1], info.aabb[0]]),
                           dtype=torch.float32, device=device)
    return Scene(info=info, pool=pool, cameras_extent=info.nerf_radius,
                 aabb=aabb, model_path=args.model_path)
