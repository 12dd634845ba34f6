# Frozen copy of s3gaussian_tpu_torch/data/cameras.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Camera container (port of ``s3gaussian_tpu/data/cameras.py``).

A ``Camera`` is a plain dataclass of tensors: the row-vector view and
full-projection transforms the rasterizer consumes, the camera centre,
the frame time, the half-angle tangents of the field of view, the
supervision rasters (the RGB image, the sparse LiDAR
depth, the DINO feature map), the masks (dynamic, sky, semantic,
instance, SAM) and its ids.  Every tensor lives on the device the caller
names; the readers keep a clip's images there.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from benchmark.frozen.ref.ops.transforms import (camera_center,
                                                 full_projection,
                                                 projection_matrix,
                                                 world_to_view)


@dataclass
class Camera:
    world_view: torch.Tensor   # [4,4] row-vector W2C^T
    full_proj: torch.Tensor    # [4,4] row-vector W2C^T @ P^T
    campos: torch.Tensor       # [3]
    time: torch.Tensor         # [] in [0,1]
    fovx: float
    fovy: float
    image_height: int
    image_width: int
    image: Optional[torch.Tensor] = None       # [H,W,3] in [0,1]
    depth_map: Optional[torch.Tensor] = None   # [H,W] lidar depth, 0 = none
    feat_map: Optional[torch.Tensor] = None    # [H,W,3] PCA'd DINO features
    dynamic_mask: Optional[torch.Tensor] = None   # [H,W] bool
    sky_mask: Optional[torch.Tensor] = None       # [H,W] bool
    semantic_mask: Optional[torch.Tensor] = None  # [H,W] int32 class ids
    instance_mask: Optional[torch.Tensor] = None  # [H,W] int32 instance ids
    sam_mask: Optional[torch.Tensor] = None       # [H,W] int32 SAM segments
    uid: int = 0
    cam_idx: int = 0
    frame_idx: int = 0
    # tan(fov/2) as 0-d float32 tensors on the camera's device, made from
    # fovx/fovy unless given: what differs between cameras reaches the
    # train step as a tensor, so a captured step serves every camera (the
    # JAX Camera's fov leaves)
    tanfovx: Optional[torch.Tensor] = None
    tanfovy: Optional[torch.Tensor] = None

    def __post_init__(self):
        dev = self.world_view.device
        if self.tanfovx is None:
            self.tanfovx = half_angle_tan(self.fovx, dev)
        if self.tanfovy is None:
            self.tanfovy = half_angle_tan(self.fovy, dev)


def half_angle_tan(fov: float, device: torch.device | str) -> torch.Tensor:
    """tan(fov/2) in float32, as the JAX Camera computes it from its
    float32 leaf."""
    return torch.tan(torch.tensor(fov, dtype=torch.float32) * 0.5).to(device)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, time: float = 0.0,
                znear: float = 0.01, zfar: float = 100.0,
                image: Optional[np.ndarray] = None,
                depth_map: Optional[np.ndarray] = None,
                feat_map: Optional[np.ndarray] = None,
                dynamic_mask: Optional[np.ndarray] = None,
                sky_mask: Optional[np.ndarray] = None,
                semantic_mask: Optional[np.ndarray] = None,
                instance_mask: Optional[np.ndarray] = None,
                sam_mask: Optional[np.ndarray] = None,
                uid: int = 0, cam_idx: int = 0, frame_idx: int = 0,
                device: torch.device | str = "cuda") -> Camera:
    """Camera from COLMAP-convention R (c2w rotation) and T (w2c
    translation), as ``scene/cameras.py:26-64`` of the reference builds it."""
    w2c = world_to_view(R, T)
    world_view = w2c.T
    fp = full_projection(w2c, projection_matrix(znear, zfar, fovx, fovy))

    def t(x, dtype=np.float32):
        return (None if x is None
                else torch.as_tensor(np.asarray(x, dtype), device=device))

    return Camera(world_view=t(world_view), full_proj=t(fp),
                  campos=t(camera_center(w2c)), time=t(time),
                  fovx=float(fovx), fovy=float(fovy),
                  image_height=int(height), image_width=int(width),
                  image=t(image), depth_map=t(depth_map),
                  feat_map=t(feat_map),
                  dynamic_mask=t(dynamic_mask, bool),
                  sky_mask=t(sky_mask, bool),
                  semantic_mask=t(semantic_mask, np.int32),
                  instance_mask=t(instance_mask, np.int32),
                  sam_mask=t(sam_mask, np.int32),
                  uid=int(uid), cam_idx=int(cam_idx),
                  frame_idx=int(frame_idx))


def camera_to_json(uid: int, cam: Camera) -> dict:
    """Reproducibility entry (reference utils/camera_utils.py:102-122):
    camera-to-world position and rotation, from the inverse of the stored
    row-vector W2C, and the focal lengths."""
    w2c = cam.world_view.cpu().numpy().T
    c2w = np.linalg.inv(w2c)
    h, w = cam.image_height, cam.image_width
    return {
        "id": uid,
        "img_name": f"{cam.frame_idx:03d}_{cam.cam_idx}",
        "width": w,
        "height": h,
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": h / (2.0 * np.tan(cam.fovy * 0.5)),
        "fx": w / (2.0 * np.tan(cam.fovx * 0.5)),
    }


def write_cameras_json(path: str, test_cams: Sequence[Camera],
                       train_cams: Sequence[Camera]) -> None:
    """cameras.json in the reference's order: test cameras, then train
    cameras (scene/__init__.py:87-96)."""
    entries = [camera_to_json(i, c)
               for i, c in enumerate(list(test_cams) + list(train_cams))]
    with open(path, "w") as f:
        json.dump(entries, f)


def nerf_norm_radius(cam_centers: np.ndarray) -> float:
    """NeRF++ scene radius from the camera centres (reference
    scene/dataset_readers.py:77-98): 1.1 x the largest distance from
    their mean."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return float(dist.max() * 1.1)
