"""Fixed-capacity Gaussian pool with masked density control (port of
``s3gaussian_tpu/models/pool.py``).

The pool keeps the JAX package's fixed capacity with an ``alive`` mask:
parameters are raw (pre-activation) tensors [Nc, ...].  ``PoolStats``
accumulates the densification statistics.  ``densify_and_prune`` clones,
splits and prunes inside the fixed capacity: a clone or the split's second
sample goes into a dead slot, the split's first sample overwrites its
source row, a prune clears the mask bit, and the Adam moments of every
touched or dead row are zeroed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.ops.knn import mean_knn_dist2
from s3gaussian_tpu_torch.ops.sh import RGB2SH
from s3gaussian_tpu_torch.ops.transforms import quat_to_rotmat
from s3gaussian_tpu_torch.utils import spans


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


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

    @property
    def n_alive(self) -> torch.Tensor:
        """0-d int32 count of the alive rows, on the pool's device."""
        return self.alive.sum(dtype=torch.int32)

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

    def with_params(self, p: Dict[str, torch.Tensor],
                    alive: Optional[torch.Tensor] = None) -> "GaussianPool":
        return GaussianPool(xyz=p["xyz"], features_dc=p["f_dc"],
                            features_rest=p["f_rest"], scaling=p["scaling"],
                            rotation=p["rotation"], opacity=p["opacity"],
                            alive=self.alive if alive is None else alive)


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


def add_densification_stats(stats: PoolStats,
                            mean2d_grad: Optional[torch.Tensor],
                            radii: torch.Tensor, visible: torch.Tensor,
                            grad_norm: Optional[torch.Tensor] = None,
                            denom_inc: Optional[torch.Tensor] = None
                            ) -> PoolStats:
    """Accumulate |grad(mean2D_ndc)| and the max screen radius over the
    visible gaussians (reference gaussian_model.py:693-695).

    ``grad_norm`` and ``denom_inc`` [Nc], when given, replace the norm and
    the count: the rig step passes the sum of its per-camera norms and
    the number of its cameras that drew each Gaussian, so the average
    matches that of B single-camera steps."""
    norm = (torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
            if grad_norm is None else grad_norm)
    inc = visible.to(torch.float32) if denom_inc is None else denom_inc
    return PoolStats(
        max_radii2d=torch.where(
            visible, torch.maximum(stats.max_radii2d, radii.to(torch.float32)),
            stats.max_radii2d),
        xyz_grad_accum=stats.xyz_grad_accum + torch.where(visible, norm, 0.0),
        denom=stats.denom + inc)


@spans.host("pool.init")
def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    max_sh_degree: int = 3,
                    device: torch.device | str = "cuda") -> GaussianPool:
    """Initialize from a (LiDAR) point cloud: DC features from RGB2SH,
    scale = log sqrt(mean 3-NN dist²) clamped >= 1e-7, identity quats,
    opacity = inv_sigmoid(0.1); dead slots get identity quats and logit
    -9.21 (sigmoid ~ 1e-4).  The host spans ``pool.init`` and, inside
    it, ``pool.knn``."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > pool capacity {capacity}")
    k = (max_sh_degree + 1) ** 2
    with spans.host("pool.knn"):
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


# ---------------------------------------------------------------------------
# density control: pure functions over (pool, Adam rows, stats)
# ---------------------------------------------------------------------------

def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[Nc] mask broadcast over the trailing dims of ``like``."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def densify_and_prune(pool: GaussianPool,
                      opt_rows: Dict[str, Tuple[torch.Tensor, ...]],
                      stats: PoolStats,
                      noise: Tuple[torch.Tensor, torch.Tensor],
                      grad_threshold: float, opacity_threshold: float,
                      scene_extent: float, percent_dense: float,
                      max_screen_size: Optional[float], max_points: int,
                      size_prune_cap: float = 0.0,
                      world_prune: Optional[bool] = None):
    """One densification step: clone + split + prune, fused, with the
    semantics of ``s3gaussian_tpu/models/pool.py::densify_and_prune``.

    ``opt_rows`` maps a pool group name to its row-shaped Adam moments,
    which get the rows' surgery (zeroed at written and dead rows).
    ``noise`` is the two standard-normal [Nc, 3] draws of the split's two
    samples.  Returns (pool, opt_rows, zeroed stats, info), ``info`` a
    dict of 0-d tensors.

    The JAX version scatters each selected row into a dead slot and drops
    the unselected rows through an out-of-range index.  Here each dead
    slot gathers the row it receives instead: the dead slot of rank r (in
    index order, the position JAX's stable dead-first sort gives it)
    takes clone r, or the second split sample of split r - n_clone.  No
    index leaves [0, Nc) and nothing waits for the host.
    """
    nc = pool.capacity
    alive = pool.alive
    n_alive = pool.n_alive
    grads = torch.where(stats.denom > 0, stats.xyz_grad_accum / stats.denom,
                        0.0)
    scaling = pool.get_scaling()
    max_scale = scaling.amax(1)
    grad_ok = (grads >= grad_threshold) & alive
    under_cap = n_alive < max_points
    small = percent_dense * scene_extent
    clone_sel = grad_ok & (max_scale <= small) & under_cap
    split_sel = grad_ok & (max_scale > small) & under_cap

    dead = ~alive
    n_dead = nc - n_alive
    clone_cum = torch.cumsum(clone_sel, 0)
    split_cum = torch.cumsum(split_sel, 0)
    n_clone, n_split = clone_cum[-1], split_cum[-1]
    # a selection is written only while dead slots last: clones first
    clone_ok = clone_sel & (clone_cum - 1 < n_dead)
    split_ok = split_sel & (split_cum - 1 + n_clone < n_dead)
    rank = torch.cumsum(dead, 0) - 1
    to_clone = dead & (rank < n_clone)
    to_split = dead & (rank >= n_clone) & (rank < n_clone + n_split)
    clone_src = torch.searchsorted(clone_cum, rank + 1).clamp(max=nc - 1)
    split_src = torch.searchsorted(split_cum, rank - n_clone + 1).clamp(
        0, nc - 1)

    # the split's samples (reference gaussian_model.py:496-522)
    rot = quat_to_rotmat(pool.rotation)
    off1 = torch.einsum("nij,nj->ni", rot, noise[0] * scaling)
    off2 = torch.einsum("nij,nj->ni", rot, noise[1] * scaling)
    new_scaling = torch.log(scaling / (0.8 * 2))

    params = pool.param_dict()
    # (second sample, first sample) of the rows a split rewrites; the
    # first overwrites its source row, which the reference prunes
    samples = {"xyz": (params["xyz"] + off2, params["xyz"] + off1),
               "scaling": (new_scaling, new_scaling)}
    new_params = {}
    for name, arr in params.items():
        out = torch.where(_rows(to_clone, arr), arr[clone_src], arr)
        second, first = samples.get(name, (arr, None))
        out = torch.where(_rows(to_split, arr), second[split_src], out)
        if first is not None:
            out = torch.where(_rows(split_ok, arr), first, out)
        new_params[name] = out

    written = to_clone | to_split
    alive = alive | written
    newly = written | split_ok
    eligible = alive & ~newly          # fresh rows are not pruned this round
    opac = torch.sigmoid(new_params["opacity"][:, 0])
    prune_opac = (opac < opacity_threshold) & eligible
    # the reference couples the screen and world size prunes to one
    # switch; world_prune decouples them for the prune-only continuation
    world_on = (world_prune if world_prune is not None
                else max_screen_size is not None)
    nothing = torch.zeros_like(alive)
    prune_screen = ((stats.max_radii2d > max_screen_size) & eligible
                    if max_screen_size is not None else nothing)
    prune_world = ((torch.exp(new_params["scaling"]).amax(1)
                    > 0.1 * scene_extent) & eligible
                   if world_on else nothing)
    size_prune = prune_screen | prune_world
    n_size_sel = size_prune.sum()
    if size_prune_cap and max_screen_size is not None:
        # per-step cap on size prunes: only the largest screen radii, up
        # to cap·n_alive rows; opacity prunes are never capped
        cap_n = (size_prune_cap * n_alive.to(torch.float32)).to(torch.int32)
        score = torch.where(size_prune, stats.max_radii2d, -torch.inf)
        order = torch.argsort(-score, stable=True)
        prune_rank = torch.empty_like(order)
        prune_rank[order] = torch.arange(nc, device=order.device)
        size_prune = size_prune & (prune_rank < cap_n)
    prune = prune_opac | size_prune
    alive = alive & ~prune

    # Adam moments survive only on old rows that stay alive
    keep = ~newly & alive
    new_opt = {name: tuple(r * _rows(keep, r).to(r.dtype) for r in rows)
               for name, rows in opt_rows.items()}

    info = {
        "n_cloned": clone_ok.sum(),
        "n_split": split_ok.sum(),
        "n_pruned": prune.sum(),
        "n_prune_opacity": prune_opac.sum(),
        "n_prune_screen": (prune_screen & prune).sum(),
        "n_prune_world": (prune_world & prune).sum(),
        "n_prune_size_capped": n_size_sel - size_prune.sum(),
        "n_alive": alive.sum(),
        "overflow": n_clone + n_split - clone_ok.sum() - split_ok.sum(),
    }
    return (pool.with_params(new_params, alive), new_opt,
            PoolStats.zeros(nc, alive.device), info)


def reset_opacity(pool: GaussianPool,
                  opt_rows: Dict[str, Tuple[torch.Tensor, ...]]):
    """opacity <- min(opacity, inverse_sigmoid(0.01)) in float32, and the
    opacity moments zeroed (reference gaussian_model.py:350-353)."""
    cap = inverse_sigmoid(torch.tensor(0.01, device=pool.opacity.device))
    params = dict(pool.param_dict(),
                  opacity=torch.minimum(pool.opacity, cap))
    new_opt = dict(opt_rows)
    new_opt["opacity"] = tuple(torch.zeros_like(r)
                               for r in opt_rows["opacity"])
    return pool.with_params(params), new_opt
