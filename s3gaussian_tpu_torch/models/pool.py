"""Fixed-capacity Gaussian pool (port of ``s3gaussian_tpu/models/pool.py``).

The pool keeps the JAX package's fixed capacity with an ``alive`` mask:
parameters are raw (pre-activation) tensors [Nc, ...].  ``PoolStats``
accumulates the densification statistics; density control itself (clone,
split, prune) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from s3gaussian_tpu_torch.ops.knn import mean_knn_dist2
from s3gaussian_tpu_torch.ops.sh import RGB2SH


@dataclass
class GaussianPool:
    xyz: torch.Tensor            # [Nc,3]
    features_dc: torch.Tensor    # [Nc,1,3]
    features_rest: torch.Tensor  # [Nc,15,3]
    scaling: torch.Tensor        # [Nc,3] log-scale
    rotation: torch.Tensor       # [Nc,4] unnormalized quat
    opacity: torch.Tensor        # [Nc,1] logit
    alive: torch.Tensor          # [Nc] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.norm(self.rotation, dim=-1,
                                                 keepdim=True)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], 1)

    def param_dict(self) -> Dict[str, torch.Tensor]:
        """The trainable tensors, named like the reference's param groups."""
        return {"xyz": self.xyz, "f_dc": self.features_dc,
                "f_rest": self.features_rest, "scaling": self.scaling,
                "rotation": self.rotation, "opacity": self.opacity}

    def with_params(self, p: Dict[str, torch.Tensor]) -> "GaussianPool":
        return GaussianPool(xyz=p["xyz"], features_dc=p["f_dc"],
                            features_rest=p["f_rest"], scaling=p["scaling"],
                            rotation=p["rotation"], opacity=p["opacity"],
                            alive=self.alive)


@dataclass
class PoolStats:
    """Densification bookkeeping (reference gaussian_model.py:50-69)."""

    max_radii2d: torch.Tensor      # [Nc] float
    xyz_grad_accum: torch.Tensor   # [Nc] accumulated |grad(mean2D_ndc)|
    denom: torch.Tensor            # [Nc]

    @staticmethod
    def zeros(capacity: int, device: torch.device | str = "cuda"
              ) -> "PoolStats":
        return PoolStats(*(torch.zeros(capacity, device=device)
                           for _ in range(3)))


def add_densification_stats(stats: PoolStats, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor,
                            visible: torch.Tensor) -> PoolStats:
    """Accumulate |grad(mean2D_ndc)| and the max screen radius over the
    visible gaussians (reference gaussian_model.py:693-695)."""
    norm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    return PoolStats(
        max_radii2d=torch.where(
            visible, torch.maximum(stats.max_radii2d, radii.to(torch.float32)),
            stats.max_radii2d),
        xyz_grad_accum=stats.xyz_grad_accum + torch.where(visible, norm, 0.0),
        denom=stats.denom + visible.to(torch.float32))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    max_sh_degree: int = 3,
                    device: torch.device | str = "cuda") -> GaussianPool:
    """Initialize from a (LiDAR) point cloud: DC features from RGB2SH,
    scale = log sqrt(mean 3-NN dist²) clamped >= 1e-7, identity quats,
    opacity = inv_sigmoid(0.1); dead slots get identity quats and logit
    -9.21 (sigmoid ~ 1e-4)."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > pool capacity {capacity}")
    k = (max_sh_degree + 1) ** 2
    dist2 = np.maximum(mean_knn_dist2(points), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def padded(x, shape, fill=0.0):
        out = np.full((capacity,) + shape, fill, dtype=np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    return GaussianPool(
        xyz=padded(points.astype(np.float32), (3,)),
        features_dc=padded(RGB2SH(np.asarray(colors, np.float32))[:, None, :],
                           (1, 3)),
        features_rest=padded(0.0, (k - 1, 3)),
        scaling=padded(scales, (3,)),
        rotation=torch.as_tensor(rot, device=device),
        opacity=padded(float(np.log(0.1 / 0.9)), (1,), fill=-9.21),
        alive=torch.as_tensor(alive, device=device),
    )
