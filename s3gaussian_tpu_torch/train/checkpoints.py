"""Checkpoints, PLY export and the cross-clip warm start (port of
``s3gaussian_tpu/train/checkpoints.py``).

  (a) the full train state -> directory ``chkpnt_{stage}_{iter}`` holding
      ``state.pt``, a ``torch.save`` of one flat dict of tensors (the
      pool, the field's ``state_dict``, the Adam moments by name with
      ``count``, the statistics, ``step``, ``aabb`` and ``nan_skips``),
      which ``torch.load(..., weights_only=True)`` reads, and the
      ``STAGE`` file ("fine 120").  Older checkpoints are deleted only
      once the new one is on disk;
  (b) PLY export of the alive Gaussians in the Inria layout, and the
      dynamic/static split export;
  (c) ``--prior_checkpoint``: only the deformation field of a previous
      clip's checkpoint moves into a fresh state, whatever the two pools'
      capacities.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.models.pool import GaussianPool, PoolStats
from s3gaussian_tpu_torch.train.optim import AdamState
from s3gaussian_tpu_torch.train.trainer import TrainState
from s3gaussian_tpu_torch.utils.ply import (gaussian_ply_fields,
                                            parse_gaussian_ply, read_ply,
                                            write_ply)

STATE_FILE = "state.pt"
POOL_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity", "alive")
STATS_FIELDS = ("max_radii2d", "xyz_grad_accum", "denom")


def _ckpt_dir(model_path: str, stage: str, iteration: int) -> str:
    return os.path.join(model_path, f"chkpnt_{stage}_{iteration}")


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The train state as one flat dict of tensors."""
    flat = {f"pool.{f}": getattr(state.pool, f).detach() for f in POOL_FIELDS}
    flat.update({f"deform.{k}": v
                 for k, v in state.deform.state_dict().items()})
    for which, tree in (("mu", state.adam.mu), ("nu", state.adam.nu)):
        for group, d in tree.items():
            flat.update({f"adam.{which}.{group}.{k}": v
                         for k, v in d.items()})
    flat["adam.count"] = state.adam.count
    flat.update({f"stats.{f}": getattr(state.stats, f) for f in STATS_FIELDS})
    flat.update(step=state.step, aabb=state.aabb, nan_skips=state.nan_skips)
    return flat


def save_checkpoint(model_path: str, stage: str, iteration: int,
                    state: TrainState, keep_others: bool = False) -> str:
    path = _ckpt_dir(model_path, stage, iteration)
    # written under a name find_checkpoint does not match, then renamed:
    # a save cut short leaves no directory that looks like a checkpoint
    tmp = os.path.join(model_path, f".{os.path.basename(path)}.partial")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_tensors(state), os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, "STAGE"), "w") as f:
        f.write(f"{stage} {iteration}")
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    # older checkpoints go only once the new one is on disk: a crash in
    # the middle of a save must leave one to resume from
    if not keep_others:
        for d in os.listdir(model_path):
            full = os.path.join(model_path, d)
            if d.startswith("chkpnt_") and full != path:
                shutil.rmtree(full, ignore_errors=True)
    return path


def find_checkpoint(model_path: str) -> Optional[Tuple[str, str, int]]:
    """Latest (path, stage, iteration) under model_path.  A fine
    checkpoint at any iteration outranks every coarse one."""
    if not os.path.isdir(model_path):
        return None
    stage_rank = {"coarse": 0, "fine": 1}
    best = best_key = None
    for d in os.listdir(model_path):
        if d.startswith("chkpnt_"):
            parts = d.split("_")
            stage, it = parts[1], int(parts[2])
            key = (stage_rank.get(stage, -1), it)
            if best_key is None or key > best_key:
                best, best_key = (os.path.join(model_path, d), stage, it), key
    return best


def _load(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)


def _deform_tensors(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("deform."):]: v for k, v in flat.items()
            if k.startswith("deform.")}


def load_checkpoint(path: str, template: TrainState
                    ) -> Tuple[TrainState, str, int]:
    """The checkpoint at ``path`` in the shapes of ``template`` (whose
    field receives the saved parameters), with its stage and iteration."""
    flat = _load(path, template.pool.xyz.device)
    pool = GaussianPool(**{f: flat[f"pool.{f}"] for f in POOL_FIELDS})
    for f in POOL_FIELDS:
        want = getattr(template.pool, f).shape
        if pool.__dict__[f].shape != want:
            raise ValueError(f"{path}: pool.{f} has shape "
                             f"{tuple(pool.__dict__[f].shape)}, the state "
                             f"{tuple(want)}")
    template.deform.load_state_dict(_deform_tensors(flat))

    def moments(which):
        return {g: {k: flat[f"adam.{which}.{g}.{k}"] for k in d}
                for g, d in template.adam.mu.items()}

    state = replace(
        template, pool=pool,
        adam=AdamState(mu=moments("mu"), nu=moments("nu"),
                       count=flat["adam.count"]),
        stats=PoolStats(*(flat[f"stats.{f}"] for f in STATS_FIELDS)),
        step=flat["step"], aabb=flat["aabb"], nan_skips=flat["nan_skips"])
    with open(os.path.join(path, "STAGE")) as f:
        stage, it = f.read().split()
    return state, stage, int(it)


def transplant_deformation(path: str, state: TrainState) -> TrainState:
    """--prior_checkpoint: only the deformation field (hexplane and MLPs)
    of the checkpoint at ``path`` moves into ``state``'s field; the pool,
    whatever its capacity, and everything else stay."""
    flat = _load(path, state.pool.xyz.device)
    state.deform.load_state_dict(_deform_tensors(flat))
    return state


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def save_ply_pool(path: str, pool: GaussianPool) -> None:
    """The alive rows in the Inria attribute layout."""
    alive = _np(pool.alive)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, gaussian_ply_fields(
        *(_np(getattr(pool, f))[alive] for f in (
            "xyz", "features_dc", "features_rest", "opacity", "scaling",
            "rotation"))))


def save_ply_split(dynamic_path: str, static_path: str, pool: GaussianPool,
                   dx) -> np.ndarray:
    """Dynamic/static split export keyed on per-Gaussian |dx|
    (gaussian_model.py:277-348): positions advanced by ``dx``; a Gaussian
    is dynamic when max|dx| exceeds its mean over the alive rows.
    Returns the dynamic mask over the pool."""
    alive = _np(pool.alive)
    dx = _np(dx)
    max_dx = np.abs(dx).max(axis=1)
    thr = max_dx[alive].mean() if alive.any() else 0.0
    dyn = (max_dx > thr) & alive
    stat = (~(max_dx > thr)) & alive
    xyz = _np(pool.xyz) + dx
    rest = [_np(getattr(pool, f)) for f in ("features_dc", "features_rest",
                                             "opacity", "scaling",
                                             "rotation")]
    for path, m in ((dynamic_path, dyn), (static_path, stat)):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_ply(path, gaussian_ply_fields(xyz[m], *(x[m] for x in rest)))
    return dyn


def load_ply_pool(path: str, capacity: Optional[int] = None,
                  max_sh_degree: int = 3,
                  device: torch.device | str = "cuda") -> GaussianPool:
    xyz, f_dc, f_rest, op, sc, rot = parse_gaussian_ply(read_ply(path),
                                                        max_sh_degree)
    n = len(xyz)
    cap = capacity or max(1 << max(n - 1, 1).bit_length(), 2048)
    if n > cap:
        raise ValueError(f"PLY holds {n} gaussians but the requested pool "
                         f"capacity is {cap}; pass capacity >= {n}")

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    rot_pad = np.zeros((cap, 4), np.float32)
    rot_pad[:, 0] = 1.0
    rot_pad[:n] = rot
    alive = np.zeros(cap, bool)
    alive[:n] = True
    return GaussianPool(xyz=pad(xyz), features_dc=pad(f_dc),
                        features_rest=pad(f_rest), scaling=pad(sc),
                        rotation=torch.as_tensor(rot_pad, device=device),
                        opacity=pad(op, fill=-9.21),
                        alive=torch.as_tensor(alive, device=device))
