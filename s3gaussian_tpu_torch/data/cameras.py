"""Camera container (port of ``s3gaussian_tpu/data/cameras.py``).

A ``Camera`` is a plain dataclass of tensors: the row-vector view and
full-projection transforms the rasterizer consumes, the camera centre,
the frame time and the supervision rasters the train step reads (the RGB
image, the sparse LiDAR depth, the DINO feature map).  The masks of the
JAX camera (dynamic, sky, semantic, instance, SAM) are not carried yet:
no ported path reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from s3gaussian_tpu_torch.ops.transforms import (camera_center,
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

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, time: float = 0.0,
                znear: float = 0.01, zfar: float = 100.0,
                image: Optional[np.ndarray] = None,
                depth_map: Optional[np.ndarray] = None,
                feat_map: Optional[np.ndarray] = None,
                device: torch.device | str = "cuda") -> Camera:
    """Camera from COLMAP-convention R (c2w rotation) and T (w2c
    translation), as ``scene/cameras.py:26-64`` of the reference builds it."""
    w2c = world_to_view(R, T)
    world_view = w2c.T
    fp = full_projection(w2c, projection_matrix(znear, zfar, fovx, fovy))

    def t(x):
        return (None if x is None
                else torch.as_tensor(np.asarray(x, np.float32), device=device))

    return Camera(world_view=t(world_view), full_proj=t(fp),
                  campos=t(camera_center(w2c)), time=t(time),
                  fovx=float(fovx), fovy=float(fovy),
                  image_height=int(height), image_width=int(width),
                  image=t(image), depth_map=t(depth_map),
                  feat_map=t(feat_map))
