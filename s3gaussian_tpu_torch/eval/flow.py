"""Scene-flow measurement: learned deformation flow against ground truth
(port of ``s3gaussian_tpu/eval/flow.py``).

The reference derives per-Gaussian scene flow from deformation deltas at
two times (``flow = dx[t+off] - dx[t]``, utils/video_utils.py:252-299)
and only visualises it.  Where the ground-truth motion of a clip is known
(a synthetic clip that writes ``gt_motion.json``), the learned flow is
scored with end-point error (EPE) over dynamic and static Gaussians
separately.

Ground-truth model: rigid boxes with constant per-frame velocity.  A
Gaussian's flow over ``dt`` frames is ``vel * dt`` for the box it sits in
at frame ``t`` (boxes translate by ``vel * t``), zero elsewhere.  The
scoring is numpy on the host; ``deformation_flow_epe`` evaluates the
port's deformation field where the pool lives.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from s3gaussian_tpu_torch.models.fields import Field
from s3gaussian_tpu_torch.models.pool import GaussianPool


def load_gt_motion(clip_dir: str) -> Optional[Dict]:
    path = os.path.join(clip_dir, "gt_motion.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def gt_flow_from_boxes(pos: np.ndarray, boxes: List[Dict], t_frame: float,
                       dt_frames: float) -> np.ndarray:
    """Ground-truth displacement over ``dt_frames`` for points ``pos``
    [N,3] at frame time ``t_frame``.  boxes: [{"center0": [3], "vel": [3]
    per frame, "half": [3]}]."""
    flow = np.zeros_like(pos, dtype=np.float32)
    for b in boxes:
        center = np.asarray(b["center0"], np.float32) + \
            np.asarray(b["vel"], np.float32) * t_frame
        half = np.asarray(b["half"], np.float32)
        inside = np.all(np.abs(pos - center) <= half, axis=1)
        flow[inside] = np.asarray(b["vel"], np.float32) * dt_frames
    return flow


def flow_epe(xyz: np.ndarray, dx_t: np.ndarray, dx_t2: np.ndarray,
             boxes: List[Dict], t_frame: float, dt_frames: float,
             alive: Optional[np.ndarray] = None) -> Dict[str, float]:
    """End-point error of the learned flow ``dx_t2 - dx_t`` against the
    box ground truth; a Gaussian belongs to a box by its deformed position
    at frame t.

    Returns epe_dynamic (mean EPE inside boxes), epe_static (outside),
    gt_motion_mean (mean |GT flow| inside boxes, the score of an all-zero
    flow), flow_recall (share of box Gaussians whose learned flow reaches
    more than half the GT magnitude along the GT direction), n_dynamic,
    n_static.
    """
    xyz = np.asarray(xyz, np.float32)
    dx_t = np.asarray(dx_t, np.float32)
    dx_t2 = np.asarray(dx_t2, np.float32)
    if alive is None:
        alive = np.ones(len(xyz), bool)
    else:
        alive = np.asarray(alive, bool)

    pos_t = xyz + dx_t
    gt = gt_flow_from_boxes(pos_t, boxes, t_frame, dt_frames)
    learned = dx_t2 - dx_t
    err = np.linalg.norm(learned - gt, axis=1)

    gt_mag = np.linalg.norm(gt, axis=1)
    dyn = (gt_mag > 1e-6) & alive
    stat = (gt_mag <= 1e-6) & alive

    out = {
        "epe_dynamic": float(err[dyn].mean()) if dyn.any() else None,
        "epe_static": float(err[stat].mean()) if stat.any() else None,
        "gt_motion_mean": float(gt_mag[dyn].mean()) if dyn.any() else None,
        "n_dynamic": int(dyn.sum()),
        "n_static": int(stat.sum()),
    }
    if dyn.any():
        along = np.sum(learned[dyn] * gt[dyn], axis=1) / \
            np.maximum(gt_mag[dyn] ** 2, 1e-12)
        out["flow_recall"] = float((along > 0.5).mean())
    else:
        out["flow_recall"] = None
    return out


@torch.no_grad()
def deformation_flow_epe(pool: GaussianPool, deform: Field,
                         aabb: torch.Tensor, gt_motion: Dict, n_frames: int,
                         offsets=(1, 3), probe_frames=None
                         ) -> Dict[str, Dict[str, float]]:
    """EPE of the trained deformation field over probe frames and flow
    offsets.  Frame t is at normalised time t/(n_frames-1), the Waymo
    reader's timestamp mapping."""
    boxes = gt_motion["boxes"]
    xyz = pool.xyz.detach().cpu().numpy()
    alive = pool.alive.cpu().numpy()
    denom = max(n_frames - 1, 1)
    if probe_frames is None:
        probe_frames = [0, n_frames // 2]

    def dx_at(frame: float) -> np.ndarray:
        t = torch.tensor(frame / denom, dtype=torch.float32,
                         device=pool.xyz.device)
        out = deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity,
                     pool.get_features(), t, aabb)
        return np.zeros_like(xyz) if out.dx is None \
            else out.dx.cpu().numpy()

    results = {}
    for t0 in probe_frames:
        for off in offsets:
            t1 = t0 + off
            if t1 >= n_frames:
                continue
            results[f"t{t0}_off{off}"] = flow_epe(
                xyz, dx_at(t0), dx_at(t1), boxes, float(t0), float(off),
                alive=alive)
    return results
