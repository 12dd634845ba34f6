"""The evaluation sweep: per-split metrics, decomposition renders,
scene-flow renders and videos (port of ``s3gaussian_tpu/eval/video.py``).

Parity: ``utils/video_utils.py`` (render_pixels :74-349, save_videos
:352-499) and ``do_evaluation`` (train.py:61-215) of the reference:

  * every camera rendered with the decomposition and dx; a split laid out
    as rigs of ``num_cams`` views sharing one time renders each rig with
    one deformation evaluation (``render_multicam``);
  * PSNR, skimage-style SSIM, LPIPS when weights load, and the
    dynamic-mask PSNR/SSIM, all from the clipped float32 render on its
    device: the 8-bit step moves SSIM by ~0.008, past the 0.005 budget;
  * frames leave the device as uint8 as soon as their rig is done and are
    returned as ``u8 / 255`` float32 numpy, as the JAX sweep returns them;
  * forward/backward scene flow from dx at ±``FLOW_OFFSET`` frames,
    rendered with flow colours through ``override_color``;
  * per-key videos at 24 fps with a timestep's cameras side by side: mp4
    through ``imageio`` where it imports and can write one, else one PNG
    per frame through ``data/images.py::write_png`` (no Pillow needed).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from s3gaussian_tpu_torch.config import PipelineParams, RasterConfig
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.data.images import write_png
from s3gaussian_tpu_torch.eval.metrics import (lpips_or_none, masked_psnr,
                                               masked_ssim, psnr,
                                               ssim_skimage)
from s3gaussian_tpu_torch.eval.visualization import (scene_flow_to_rgb, to8b,
                                                     visualize_depth)
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool
from s3gaussian_tpu_torch.render.renderer import render, render_multicam
from s3gaussian_tpu_torch.train.checkpoints import save_ply_split

FRAME_KEYS = ("rgbs", "gt_rgbs", "depths", "dynamic_rgbs", "static_rgbs",
              "forward_flows", "backward_flows")
METRIC_KEYS = ("psnr", "ssim", "masked_psnr", "masked_ssim", "lpips")
FLOW_OFFSET = 3      # frames between the two dx of a flow render
FPS = 24


def _to8b_dev(x: torch.Tensor) -> torch.Tensor:
    """[3,H,W] float -> [H,W,3] uint8 on its device."""
    x = torch.clamp(x, 0.0, 1.0).permute(1, 2, 0)
    return torch.round(x * 255.0).to(torch.uint8)


def _host_frame(x: torch.Tensor) -> np.ndarray:
    """[3,H,W] render -> [H,W,3] float32 numpy in steps of 1/255."""
    return _to8b_dev(x).cpu().numpy().astype(np.float32) / 255.0


def rig_groups(cameras: Sequence[Camera], num_cams: int
               ) -> Optional[List[Sequence[Camera]]]:
    """The split as consecutive rigs of ``num_cams`` cameras when it is
    laid out so (a whole number of rigs, one time within each to 1e-9,
    every camera with or every one without a dynamic mask), else None."""
    if num_cams <= 1 or len(cameras) < num_cams \
            or len(cameras) % num_cams:
        return None
    groups = [cameras[i:i + num_cams]
              for i in range(0, len(cameras), num_cams)]
    if not all(abs(float(c.time) - float(g[0].time)) < 1e-9
               for g in groups for c in g[1:]):
        return None
    if not all((c.dynamic_mask is None) == (cameras[0].dynamic_mask is None)
               for c in cameras):
        return None
    return groups


def view_metrics(rgb: torch.Tensor, cam: Camera) -> Dict[str, float]:
    """The metrics of one view from its float32 render [3,H,W]: psnr,
    ssim, lpips where its weights load (``lpips_or_none``), and where the
    camera carries a dynamic mask with any pixel, masked_psnr and
    masked_ssim."""
    rgbf = torch.clamp(rgb, 0.0, 1.0).permute(1, 2, 0)
    met = {"psnr": psnr(rgbf, cam.image), "ssim": ssim_skimage(rgbf,
                                                               cam.image)}
    if cam.dynamic_mask is not None:
        met["mask_any"] = cam.dynamic_mask.any()
        met["masked_psnr"] = masked_psnr(rgbf, cam.image, cam.dynamic_mask)
        met["masked_ssim"] = masked_ssim(rgbf, cam.image, cam.dynamic_mask)
    vals = dict(zip(met, torch.stack([v.double() for v in met.values()])
                    .tolist()))          # one wait for the device
    if not vals.pop("mask_any", False):
        vals.pop("masked_psnr", None)
        vals.pop("masked_ssim", None)
    lp = lpips_or_none(rgbf, cam.image)
    if lp is not None:
        vals["lpips"] = lp
    return vals


@torch.no_grad()
def render_pixels(cameras: Sequence[Camera], pool: GaussianPool,
                  deform: Optional[DeformationField], pipe: PipelineParams,
                  bg: torch.Tensor, aabb: Optional[torch.Tensor],
                  active_sh_degree: int, stage: str, cfg: RasterConfig,
                  compute_metrics: bool = True,
                  return_decomposition: bool = True,
                  num_cams: int = 3,
                  save_separate_pcd: bool = False,
                  pcd_dir: str = "") -> Dict:
    """Render every camera of a split; collect frames and metrics
    (video_utils.py:74-349).  Returns the non-empty frame lists of
    ``FRAME_KEYS`` (one entry per camera, index-aligned with
    ``cameras``), and with ``compute_metrics`` ``metrics`` (each key's
    mean over the views that have it, None where none has) and
    ``metrics_per_view``.  Metrics need every camera's ``image``."""
    out: Dict[str, List] = {k: [] for k in FRAME_KEYS}
    metrics: Dict[str, List] = {k: [] for k in METRIC_KEYS}
    dx_per_cam: List[Optional[torch.Tensor]] = []
    fine = "fine" in stage

    def collect(cams, pkg):
        """Frames, dx and metrics of one render of ``cams`` (stacked)."""
        rd, rs = pkg.get("render_d"), pkg.get("render_s")
        for b, cam in enumerate(cams):
            out["rgbs"].append(_host_frame(pkg["render"][b]))
            if cam.image is not None:
                out["gt_rgbs"].append(cam.image.cpu().numpy())
            out["depths"].append(pkg["depth"][b].cpu().numpy())
            if return_decomposition and rd is not None:
                out["dynamic_rgbs"].append(_host_frame(rd[b]))
                out["static_rgbs"].append(_host_frame(rs[b]))
            # one deformation per rig: its cameras share dx
            dx_per_cam.append(pkg.get("dx"))
            if compute_metrics:
                vals = view_metrics(pkg["render"][b], cam)
                for k in METRIC_KEYS:
                    if k in vals:
                        metrics[k].append(vals[k])
                    elif k == "lpips":
                        metrics[k].append(None)

    groups = rig_groups(cameras, num_cams)
    if groups is not None:
        for g in groups:
            collect(g, render_multicam(
                g, pool, deform, pipe, bg, aabb, active_sh_degree,
                stage=stage, return_decomposition=return_decomposition
                and fine, cfg=cfg))
    else:
        for cam in cameras:
            pkg = render(cam, pool, deform, pipe, bg, aabb, active_sh_degree,
                         stage=stage,
                         return_decomposition=return_decomposition,
                         return_dx=fine, cfg=cfg)
            collect([cam], {k: (v[None] if k in ("render", "depth",
                                                 "render_d", "render_s")
                                else v) for k, v in pkg.items()})

    # dynamic/static split PLY export keyed on |dx| at the reference's
    # probe view (video_utils.py:243-250 -> gaussian_model.py:277-348)
    have_dx = [d for d in dx_per_cam if d is not None]
    if save_separate_pcd and len(have_dx) > 1:
        probe = have_dx[min(24, len(have_dx) - 1)]
        save_ply_split(os.path.join(pcd_dir, "dynamic.ply"),
                       os.path.join(pcd_dir, "static.ply"), pool, probe)

    # scene flow from dx differences across timesteps (video_utils.py:252-299)
    if have_dx and len(cameras) > num_cams:
        n = len(cameras)
        for i, cam in enumerate(cameras):
            if dx_per_cam[i] is None:
                continue
            for key, j in (("forward_flows",
                            min(i + FLOW_OFFSET * num_cams, n - 1)),
                           ("backward_flows",
                            max(i - FLOW_OFFSET * num_cams, 0))):
                colors = scene_flow_to_rgb(dx_per_cam[j] - dx_per_cam[i],
                                           flow_max_radius=2.0)
                pkg = render(cam, pool, deform, pipe, bg, aabb,
                             active_sh_degree, stage=stage,
                             override_color=colors, cfg=cfg)
                out[key].append(_host_frame(pkg["render"]))

    result: Dict = {k: v for k, v in out.items() if v}
    if compute_metrics:
        summary = {}
        for k, v in metrics.items():
            vals = [x for x in v if x is not None]
            summary[k] = float(np.mean(vals)) if vals else None
        result["metrics"] = summary
        # per-view values (None where a view had none); the masked ones
        # only for views whose mask has a pixel
        result["metrics_per_view"] = {k: list(v) for k, v in metrics.items()}
    return result


def save_videos(frames: Dict, save_pth: str, num_timestamps: int) -> None:
    """Per-key video with the cameras of one timestep side by side
    (video_utils.py:352-499): ``{key}.mp4`` through imageio, or where
    imageio is missing or has no mp4 backend, ``{key}_{i:03d}.png`` per
    frame."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    os.makedirs(save_pth, exist_ok=True)
    # frame sequences only: render_pixels also returns dict-valued
    # entries ("metrics", "metrics_per_view")
    for key, seq in frames.items():
        if not isinstance(seq, list) or not seq:
            continue
        vid = []
        per_t = max(len(seq) // num_timestamps, 1)
        for t in range(num_timestamps):
            row = seq[t * per_t:(t + 1) * per_t]
            if not row:
                break
            if row[0].ndim == 2:  # depth
                vid.append(np.concatenate([visualize_depth(r) for r in row],
                                          axis=1))
            else:
                vid.append(to8b(np.concatenate(row, axis=1)))
        if imageio is not None:
            try:
                imageio.mimwrite(os.path.join(save_pth, f"{key}.mp4"), vid,
                                 fps=FPS)
                continue
            except (ValueError, OSError, RuntimeError):
                pass        # no mp4 backend (ffmpeg): frames as PNGs
        for i, f in enumerate(vid):
            write_png(os.path.join(save_pth, f"{key}_{i:03d}.png"), f)


def do_evaluation(train_cams, test_cams, full_cams, pool: GaussianPool,
                  deform: Optional[DeformationField], pipe: PipelineParams,
                  bg: torch.Tensor, aabb: Optional[torch.Tensor],
                  active_sh_degree: int, stage: str, cfg: RasterConfig,
                  eval_dir: str, step: int = 0, num_cams: int = 3,
                  save_separate_pcd: bool = False, write: bool = True
                  ) -> Dict:
    """train.py:61-215: the ``test``, ``train`` and ``full`` splits, empty
    ones skipped; per split ``metrics/{step}_images_{split}_{timestamp}.json``
    (the summary) and the videos under ``{split}_set_{step}/``; with
    ``save_separate_pcd`` the dynamic/static PLYs of the full split under
    ``pcd/``.  ``write=False`` computes everything and writes nothing.
    Returns {split: summary}."""
    if write:
        os.makedirs(os.path.join(eval_dir, "metrics"), exist_ok=True)
    results = {}
    splits = {"test": test_cams, "train": train_cams, "full": full_cams}
    for split, cams in splits.items():
        if not cams:
            continue
        frames = render_pixels(cams, pool, deform, pipe, bg, aabb,
                               active_sh_degree, stage, cfg,
                               num_cams=num_cams,
                               save_separate_pcd=(save_separate_pcd
                                                  and write
                                                  and split == "full"),
                               pcd_dir=os.path.join(eval_dir, "pcd"))
        metrics = frames.get("metrics", {})
        results[split] = metrics
        if not write:
            continue
        ts = time.strftime("%Y%m%d%H%M%S")
        with open(os.path.join(eval_dir, "metrics",
                               f"{step}_images_{split}_{ts}.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        save_videos(frames, os.path.join(eval_dir, f"{split}_set_{step}"),
                    num_timestamps=max(len(cams) // num_cams, 1))
    return results
