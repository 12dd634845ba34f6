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

import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from s3gaussian_tpu_torch.config import PipelineParams, RasterConfig
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.data.images import write_png
from s3gaussian_tpu_torch.eval.lpips import available as lpips_available
from s3gaussian_tpu_torch.eval.lpips import lpips
from s3gaussian_tpu_torch.eval.metrics import (masked_psnr, masked_ssim,
                                               psnr, ssim_skimage)
from s3gaussian_tpu_torch.eval.visualization import (scene_flow_to_rgb, to8b,
                                                     visualize_depth)
from s3gaussian_tpu_torch.models.fields import Field
from s3gaussian_tpu_torch.models.pool import GaussianPool
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.render.renderer import render_multicam
from s3gaussian_tpu_torch.train import graphs
from s3gaussian_tpu_torch.train.checkpoints import save_ply_split

FRAME_KEYS = ("rgbs", "gt_rgbs", "depths", "dynamic_rgbs", "static_rgbs",
              "forward_flows", "backward_flows")
METRIC_KEYS = ("psnr", "ssim", "masked_psnr", "masked_ssim", "lpips")
FLOW_OFFSET = 3      # frames between the two dx of a flow render
FPS = 24


# camera rasters no sweep render reads (the JAX sweep's ``_slim``); the
# metrics read the image and the dynamic mask
SLIM_FIELDS = ("depth_map", "feat_map", "sky_mask", "semantic_mask",
               "instance_mask", "sam_mask")
TRUTH_FIELDS = ("image", "dynamic_mask")
# renders in flight before the oldest one's outputs are read (the JAX
# sweep's dispatch-ahead window)
WINDOW = 2
OVERFLOW_KEYS = ("overflow_rect", "overflow_visible", "overflow_pairs")


def _to8b_dev(x: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] float -> [..., H, W, 3] uint8 on its device."""
    x = torch.clamp(x, 0.0, 1.0).movedim(-3, -1)
    return torch.round(x * 255.0).to(torch.uint8)


def _slim(cam: Camera, keep_truth: bool) -> Camera:
    """``cam`` without the rasters a sweep render never reads; with
    ``keep_truth`` it keeps the image and dynamic mask the metrics read."""
    return dataclasses.replace(cam, **dict.fromkeys(
        SLIM_FIELDS + (() if keep_truth else TRUTH_FIELDS)))


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


def metric_tensors(rgb: torch.Tensor, cam: Camera,
                   with_lpips: bool) -> Dict[str, torch.Tensor]:
    """The metrics of one view from its float32 render [3,H,W] as 0-d
    float64 tensors on its device: psnr, ssim, lpips when
    ``with_lpips``, and where the camera carries a dynamic mask,
    mask_any (0 or 1), masked_psnr and masked_ssim."""
    rgbf = torch.clamp(rgb, 0.0, 1.0).permute(1, 2, 0)
    met = {"psnr": psnr(rgbf, cam.image),
           "ssim": ssim_skimage(rgbf, cam.image)}
    if with_lpips:
        met["lpips"] = lpips(rgbf, cam.image).double()
    if cam.dynamic_mask is not None:
        met["mask_any"] = cam.dynamic_mask.any().double()
        met["masked_psnr"] = masked_psnr(rgbf, cam.image, cam.dynamic_mask)
        met["masked_ssim"] = masked_ssim(rgbf, cam.image, cam.dynamic_mask)
    return met


def _metric_values(vals: Dict[str, float]) -> Dict[str, float]:
    """One view's metrics as the sweep keeps them: the masked ones only
    where the mask has a pixel."""
    vals = dict(vals)
    if not vals.pop("mask_any", 0.0):
        vals.pop("masked_psnr", None)
        vals.pop("masked_ssim", None)
    return vals


def view_metrics(rgb: torch.Tensor, cam: Camera) -> Dict[str, float]:
    """``metric_tensors`` of one view as floats, LPIPS where its weights
    load, in one wait for the device."""
    met = metric_tensors(rgb, cam, lpips_available("alex", rgb.device))
    return _metric_values(dict(zip(met, torch.stack(list(met.values()))
                                   .tolist())))


def _sweep_render(pool: GaussianPool, deform: Optional[Field],
                  pipe: PipelineParams, bg: torch.Tensor,
                  aabb: Optional[torch.Tensor], sh_deg: int, stage: str,
                  cfg: RasterConfig, decomp: bool, want_dx: bool,
                  with_metrics: bool, with_lpips: bool):
    """What one render of the sweep computes (the JAX sweep's jitted
    ``run``): ``fn(cams, override_color=None)`` renders a rig of one or
    more cameras (``render_multicam``) and returns its frames as uint8
    ``[B,H,W,3]`` (``render``, with the decomposition
    ``render_d``/``render_s``), ``depth [B,H,W]``, with ``want_dx`` the
    ``dx`` the field gives, the render's ``overflow`` counters [3], and
    with metrics ``metrics [K,B]`` float64 from the float32 render, named
    by ``metric_names``; nothing else."""

    def fn(cams: Sequence[Camera], override_color=None):
        pkg = render_multicam(cams, pool, deform, pipe, bg, aabb, sh_deg,
                              stage=stage, return_decomposition=decomp,
                              cfg=cfg, override_color=override_color)
        out = {k: _to8b_dev(pkg[k]) for k in ("render", "render_d",
                                              "render_s") if k in pkg}
        out["depth"] = pkg["depth"]
        if want_dx and pkg["dx"] is not None:
            out["dx"] = pkg["dx"]
        aux = pkg["raster_aux"]
        out["overflow"] = torch.stack([torch.as_tensor(aux[k]).to(
            torch.int64) for k in OVERFLOW_KEYS])
        if with_metrics:
            mets = [metric_tensors(pkg["render"][b], cam, with_lpips)
                    for b, cam in enumerate(cams)]
            out["metric_names"] = tuple(mets[0])
            out["metrics"] = torch.stack([torch.stack(list(m.values()))
                                          for m in mets], 1)
        return out

    return fn


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A stream-ordered copy of ``x`` into page-locked host memory (the
    caller waits on an event before reading it)."""
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x, non_blocking=True)


def _to_host(out: Dict, gts: Sequence[torch.Tensor], on_card: bool):
    """The outputs of one render copied where the host reads them, and
    the ground truth images ``gts``: on the card, into pinned buffers
    behind an event (``dx`` cloned on the card), so the next replay may
    overwrite the graph's buffers; on the CPU, as they are.  Returns
    (host dict, event or None)."""
    host = {k: v for k, v in out.items() if k == "metric_names"}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            host[k] = (v.clone() if k == "dx" else _pinned(v)) if on_card \
                else v
    if gts:
        host["gt"] = [_pinned(g) if g.is_cuda else g for g in gts]
    if not on_card:
        return host, None
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


@torch.no_grad()
def render_pixels(cameras: Sequence[Camera], pool: GaussianPool,
                  deform: Optional[Field], pipe: PipelineParams,
                  bg: torch.Tensor, aabb: Optional[torch.Tensor],
                  active_sh_degree: int, stage: str, cfg: RasterConfig,
                  compute_metrics: bool = True,
                  return_decomposition: bool = True,
                  num_cams: int = 3,
                  save_separate_pcd: bool = False,
                  pcd_dir: str = "",
                  stats: Optional[Dict] = None) -> Dict:
    """Render every camera of a split; collect frames and metrics
    (video_utils.py:74-349).  Returns the non-empty frame lists of
    ``FRAME_KEYS`` (one entry per camera, index-aligned with
    ``cameras``), and with ``compute_metrics`` ``metrics`` (each key's
    mean over the views that have it, None where none has) and
    ``metrics_per_view``.  Metrics need every camera's ``image``.

    Each rig (or camera) is one render of ``_sweep_render``; on the card
    a replay of it captured as one CUDA graph per key
    (``train/graphs.py::render_graph``: stage, SH degree, decomposition,
    dx, override colours, cameras a render, H×W, the camera tensors
    present, the pool, the settings, metrics, LPIPS), with at most
    ``WINDOW`` renders in flight: a render's frames, depth and metrics
    are copied to pinned host memory before the next replay, and read
    once the render after it is dispatched.  The flow renders replay one
    ``override_color`` graph.  The graph is released at the end.  On the
    CPU each render runs eagerly.  ``stats``, when given, receives the
    captures (what, warm-up ms, capture ms, compositor launches), the
    replays, the largest overflow counters and the seconds of the
    renders and of the flow renders."""
    on_card = pool.xyz.is_cuda
    out: Dict[str, List] = {k: [] for k in FRAME_KEYS}
    metrics: Dict[str, List] = {k: [] for k in METRIC_KEYS}
    dx_per_cam: List[Optional[torch.Tensor]] = []
    fine = "fine" in stage
    with_lpips = compute_metrics and lpips_available("alex", pool.xyz.device)
    st = {"captures": [], "replays": 0,
          "overflow": dict.fromkeys(OVERFLOW_KEYS, 0)}
    pending: deque = deque()

    def dispatch(what, fn, cams, gts, drain, **inputs):
        """One render of ``cams``: its graph replayed (captured first
        where the held one has another key) or, on the CPU, ``fn``; its
        outputs and the ground truth images ``gts`` on their way to the
        host."""
        if on_card:
            key = ("sweep", what, stage, active_sh_degree,
                   return_decomposition, fine, bool(inputs), len(cams),
                   cams[0].image_height, cams[0].image_width,
                   tuple(tuple(sorted(graphs.camera_tensors(c)))
                         for c in cams), pool.capacity, pool.xyz.data_ptr(),
                   id(deform), bg.data_ptr(), repr(pipe), repr(cfg),
                   compute_metrics, with_lpips)
            held = graphs.current()
            g = graphs.render_graph(key, fn, cams, inputs)
            if g is not held:
                st["captures"].append((what, g.warmup_ms, g.capture_ms,
                                       tk.compositor_launches(g.captured)))
            res = g.run(cams, **inputs)
            st["replays"] += 1
        else:
            res = fn(cams, **inputs)
        pending.append((cams, drain, *_to_host(res, gts, on_card)))
        if len(pending) >= WINDOW:
            collect()

    def collect():
        cams, drain, host, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        for k, v in zip(OVERFLOW_KEYS, host["overflow"].tolist()):
            st["overflow"][k] = max(st["overflow"][k], v)
        drain(cams, host)

    def frames8(x: torch.Tensor) -> List[np.ndarray]:
        return list(x.numpy().astype(np.float32) / 255.0)

    def drain_render(cams, host):
        """Frames, dx and metrics of one render of ``cams``."""
        out["rgbs"] += frames8(host["render"])
        out["gt_rgbs"] += [g.numpy() for g in host.get("gt", [])]
        out["depths"] += list(host["depth"].numpy())
        if return_decomposition and "render_d" in host:
            out["dynamic_rgbs"] += frames8(host["render_d"])
            out["static_rgbs"] += frames8(host["render_s"])
        # one deformation per rig: its cameras share dx
        dx_per_cam.extend([host.get("dx")] * len(cams))
        if compute_metrics:
            names = host["metric_names"]
            for col in host["metrics"].t().tolist():
                vals = _metric_values(dict(zip(names, col)))
                for k in METRIC_KEYS:
                    if k in vals:
                        metrics[k].append(vals[k])
                    elif k == "lpips":
                        metrics[k].append(None)

    def sweep_fn(decomp, want_dx, with_metrics):
        return _sweep_render(pool, deform, pipe, bg, aabb, active_sh_degree,
                             stage, cfg, decomp, want_dx, with_metrics,
                             with_metrics and with_lpips)

    t0 = time.perf_counter()
    groups = rig_groups(cameras, num_cams)
    fn = sweep_fn(return_decomposition and fine, fine, compute_metrics)
    units, what = ((groups, "rig") if groups is not None
                   else ([[c] for c in cameras], "camera"))
    for unit in units:
        dispatch(what, fn, [_slim(c, compute_metrics) for c in unit],
                 [c.image for c in unit if c.image is not None],
                 drain_render)
    while pending:
        collect()
    st["render_s"] = time.perf_counter() - t0

    # dynamic/static split PLY export keyed on |dx| at the reference's
    # probe view (video_utils.py:243-250 -> gaussian_model.py:277-348)
    have_dx = [d for d in dx_per_cam if d is not None]
    if save_separate_pcd and len(have_dx) > 1:
        probe = have_dx[min(24, len(have_dx) - 1)]
        save_ply_split(os.path.join(pcd_dir, "dynamic.ply"),
                       os.path.join(pcd_dir, "static.ply"), pool, probe)

    # scene flow from dx differences across timesteps (video_utils.py:252-299)
    t0 = time.perf_counter()
    if have_dx and len(cameras) > num_cams:
        n = len(cameras)
        flow_fn = sweep_fn(False, False, False)
        for i, cam in enumerate(cameras):
            if dx_per_cam[i] is None:
                continue
            for key, j in (("forward_flows",
                            min(i + FLOW_OFFSET * num_cams, n - 1)),
                           ("backward_flows",
                            max(i - FLOW_OFFSET * num_cams, 0))):
                colors = scene_flow_to_rgb(dx_per_cam[j] - dx_per_cam[i],
                                           flow_max_radius=2.0)
                dispatch("flow", flow_fn, [_slim(cam, False)], [],
                         lambda cams, host, key=key: out[key].extend(
                             frames8(host["render"])),
                         override_color=colors)
        while pending:
            collect()
    st["flow_s"] = time.perf_counter() - t0
    if on_card:
        graphs.release()
    if stats is not None:
        stats.update(st)

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
                  deform: Optional[Field], pipe: PipelineParams,
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
