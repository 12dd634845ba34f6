# Frozen copy of s3gaussian_tpu_torch/ops/transforms.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Camera and rigid-transform math (port of ``s3gaussian_tpu/ops/transforms.py``).

Matrix convention follows the reference: the rasterizer consumes
*transposed* (row-vector) matrices, ``world_view_transform = W2C^T`` and
``full_proj_transform = W2C^T @ P^T``, so points transform as ``p @ M``.
The camera-setup helpers stay numpy (they run once per camera on the
host, as in the JAX package); the per-Gaussian quaternion math is torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3];
    normalizes first like ``build_rotation``."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Normalized Hamilton product of (w,x,y,z) quaternions, batched."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    out = torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray = np.zeros(3),
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix (``getWorld2View2``).  ``R`` is the
    camera-to-world rotation, ``t`` the world-to-camera translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Perspective projection with z in [0,1] NDC (``getProjectionMatrix``)."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def full_projection(world_view: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """Row-vector composite transform ``W2C^T @ P^T``."""
    return (np.asarray(world_view).T @ np.asarray(proj).T).astype(np.float32)


def camera_center(world_view: np.ndarray) -> np.ndarray:
    """Camera origin in world space = inverse(W2C)[:3, 3]."""
    return np.linalg.inv(np.asarray(world_view))[:3, 3].astype(np.float32)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
