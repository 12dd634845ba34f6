#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``s3gaussian_tpu_torch``) on one
NVIDIA Hopper GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero before the
last line):

  1. the card (``nvidia-smi`` name and power limit), capability 9.0;
  2. build the CUDA forward compositor from ``s3gaussian_tpu_torch/csrc``;
  3. kernel vs its plain PyTorch version on the sorted pair stream of one
     full-width view and of a high-opacity variant (early exit), with the
     tolerances of ``tests/test_tile_kernels.py``, and both times;
  4. the slice: the headline scene of ``bench.py`` (200,000 LiDAR-like
     Gaussians in a 204,800 pool, SH degree 3, default deformation field)
     rendered at 640x960 through ``render()`` for 3 rig cameras x 2 times
     and through ``eval.video.render_pixels`` with the decomposition, the
     kernel launch counter checked against the rasterize calls; per-frame
     times and a split by stage;
  5. the same render on a small scene on the GPU and on the CPU (plain
     compositor), which must agree.

Then one JSON line per kernel, the card line, and last
``{"ok": true, "device": {...}}``.  The port imports no jax; neither
does this script.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np

H, W = 640, 960
N_GAUSSIANS = 200_000
CAPACITY = 204_800
TIMES = (0.4, 0.6)
YAWS_DEG = (-40.0, 0.0, 40.0)
# tests/test_tile_kernels.py:46-49
RGBD_ATOL, RGBD_RTOL, FINAL_T_ATOL, N_CONTRIB_ATOL = 5e-4, 1e-4, 2e-4, 1.0


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def make_scene(torch, dev, n, cap, seed=0):
    """bench.py's "frustum" scene: LiDAR-like points in the view frustum,
    sized by create_from_pcd's 3-NN rule."""
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    rng = np.random.default_rng(seed)
    tan = np.tan(0.5)
    z = rng.uniform(1.0, 60.0, n)
    pts = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                    rng.uniform(-0.9, 0.9, n) * tan * z, z],
                   1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return create_from_pcd(pts, cols, cap, device=dev)


def rig_camera(torch, dev, yaw_deg, t, h, w):
    """A rig camera at the ego centre looking along ``yaw`` (bench.py's
    FRONT_LEFT / FRONT / FRONT_RIGHT geometry)."""
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.ops.transforms import projection_matrix
    yaw = math.radians(yaw_deg)
    cy, sy = math.cos(yaw), math.sin(yaw)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]],
                            np.float32)
    full = (view @ projection_matrix(0.01, 100.0, 1.0, 1.0).T).astype(
        np.float32)
    return Camera(world_view=torch.tensor(view, device=dev),
                  full_proj=torch.tensor(full, device=dev),
                  campos=torch.zeros(3, device=dev),
                  time=torch.tensor(t, dtype=torch.float32, device=dev),
                  fovx=1.0, fovy=1.0, image_height=h, image_width=w)


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_stages(torch, cam, pool, deform, pipe, bg, aabb, cfg):
    """render()'s fine path split into its stages with CUDA events between
    them.  Returns (ms per stage, [T,8,P] compositor output)."""
    from s3gaussian_tpu_torch.ops import rasterizer as rz
    from s3gaussian_tpu_torch.ops.project import sh_to_color
    from s3gaussian_tpu_torch.ops.tile_kernels import composite_fwd
    from s3gaussian_tpu_torch.render.renderer import make_settings
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.no_grad():
        ev[0].record()
        shs = pool.get_features()
        d = deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity, shs,
                   cam.time.reshape(()), aabb)
        ev[1].record()
        settings = make_settings(cam, bg, 3)
        colors = sh_to_color(d.shs, pool.xyz, cam.campos, 3)
        rot = d.rotations / torch.linalg.norm(d.rotations, dim=-1,
                                              keepdim=True)
        _, pk, feat_pool = rz.project_and_key(
            settings, d.xyz, torch.sigmoid(d.opacity)[:, 0],
            scales=torch.exp(d.scales), rotations=rot, colors_precomp=colors,
            alive=pool.alive, cfg=cfg)
        ev[2].record()
        gx, gy = rz.grid_dims(settings, cfg)
        stream, tile_starts, _, _ = rz.sort_stream(
            feat_pool, pk, gx * gy, cfg.rect_cap, cfg.pair_budget)
        ev[3].record()
        out = composite_fwd(stream, tile_starts, gx, gy, cfg.tile_x,
                            cfg.tile_y)
        ev[4].record()
    torch.cuda.synchronize()
    names = ("deformation", "projection+keys", "sort+gather", "compositor")
    return ({n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)},
            out, stream, tile_starts)


def compare_tiles(got, want):
    """Kernel vs plain [T,8,P] at the tolerances of the Pallas tests.
    Returns the max abs error over rows 0-4."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    rgbd_ok = bool((err[:, 0:4] <= RGBD_ATOL + RGBD_RTOL * w[:, 0:4].abs())
                   .all())
    check(rgbd_ok, f"rgb/depth differ: max abs {float(err[:, 0:4].max())}")
    check(float(err[:, 4].max()) <= FINAL_T_ATOL,
          f"final_T differs by {float(err[:, 4].max())}")
    check(float(err[:, 5].max()) <= N_CONTRIB_ATOL,
          f"n_contrib differs by {float(err[:, 5].max())}")
    check(bool((got[:, 6:] == 0).all()), "pad rows are not zero")
    return float(err[:, 0:5].max())


def main() -> int:
    import torch

    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.eval.video import render_pixels
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.ops.composite import composite_tiles_torch
    from s3gaussian_tpu_torch.render.renderer import render

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"capability {cap}: the kernel is built for sm_90a")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap}", flush=True)
    dev = configure_device("cuda")

    # 2. build
    t0 = time.time()
    log = tk.build()
    build_s = time.time() - t0
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln)
    print(f"build: {build_s:.2f} s -> {tk.library_path().name} [{ptxas}]",
          flush=True)

    # the slice: bench.py's headline workload
    t0 = time.time()
    pool = make_scene(torch, dev, N_GAUSSIANS, CAPACITY)
    hp = ModelHiddenParams()
    deform = DeformationField(hp, torch.Generator().manual_seed(0), dev)
    deform.eval()
    aabb = torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                        device=dev)
    pipe = PipelineParams()
    cfg = RasterConfig(tile_x=16, tile_y=16, max_visible=CAPACITY, rect_w=4,
                       rect_h=4, pair_budget=1 << 22, chunk=128,
                       big_budget=0, tight_rect=True)
    bg = torch.zeros(3, device=dev)
    cams = [rig_camera(torch, dev, yaw, t, H, W)
            for t in TIMES for yaw in YAWS_DEG]
    torch.cuda.synchronize()
    print(f"scene: {N_GAUSSIANS} gaussians in a {CAPACITY} pool, "
          f"{len(cams)} cameras {H}x{W}, set-up {time.time() - t0:.2f} s",
          flush=True)

    # 3. kernel vs plain on the card, full-width view + high opacity
    gx, gy = -(-W // cfg.tile_x), -(-H // cfg.tile_y)
    _, _, stream, tile_starts = frame_stages(torch, cams[1], pool, deform,
                                             pipe, bg, aabb, cfg)
    hi_pool = copy.copy(pool)
    op = np.random.default_rng(1).uniform(0.9, 0.99, CAPACITY)
    hi_pool.opacity = torch.tensor(np.log(op / (1 - op)), dtype=torch.float32,
                                   device=dev)[:, None]
    _, _, hi_stream, hi_starts = frame_stages(torch, cams[1], hi_pool, deform,
                                              pipe, bg, aabb, cfg)
    max_err = 0.0
    times = {}
    for name, (s, ts) in {"view": (stream, tile_starts),
                          "high_opacity": (hi_stream, hi_starts)}.items():
        got = tk.composite_fwd(s, ts, gx, gy, cfg.tile_x, cfg.tile_y)
        want = composite_tiles_torch(s, ts, gx, gy, cfg.tile_x, cfg.tile_y)
        torch.cuda.synchronize()
        err = compare_tiles(got, want)
        max_err = max(max_err, err)
        ms = cuda_ms(torch, lambda: tk.composite_fwd(
            s, ts, gx, gy, cfg.tile_x, cfg.tile_y), reps=20)
        plain_ms = cuda_ms(torch, lambda: composite_tiles_torch(
            s, ts, gx, gy, cfg.tile_x, cfg.tile_y), reps=3, warmup=1)
        times[name] = (ms, plain_ms)
        n_pairs = int(ts[-1])
        print(f"kernel vs plain [{name}]: M={s.shape[1]} n_pairs={n_pairs} "
              f"tiles={gx * gy} max_abs_err={err:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms ({card})", flush=True)

    # 4. the slice through the user entry points, launches counted
    rasterize_calls = 0
    frame_ms = []
    renders = []
    tk.launches = 0
    for cam in cams:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkg = render(cam, pool, deform, pipe, bg, aabb, 3, stage="fine",
                     cfg=cfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        rasterize_calls += 1
        aux = pkg["raster_aux"]
        check(pkg["render"].shape == (3, H, W), "render shape")
        check(bool(torch.isfinite(pkg["render"]).all()
                   and torch.isfinite(pkg["depth"]).all()),
              "non-finite render")
        check(int(aux["n_pairs"]) > 0, "no pairs rendered")
        check(int(aux["overflow_pairs"]) == 0,
              f"{int(aux['overflow_pairs'])} pairs beyond the budget")
        renders.append(pkg["render"])
    frames = render_pixels(cams, pool, deform, pipe, bg, aabb, 3, "fine", cfg,
                           return_decomposition=True)
    rasterize_calls += 3 * len(cams)
    torch.cuda.synchronize()
    launches = tk.launches
    check(launches == rasterize_calls,
          f"{launches} kernel launches for {rasterize_calls} rasterize calls")
    for img, frame in zip(renders, frames["rgbs"]):
        check(torch.allclose(frame, torch.clamp(img, 0, 1).permute(1, 2, 0),
                             rtol=0.0, atol=1e-5),
              "render_pixels frame differs from render()")
    check(len(frames["dynamic_rgbs"]) == len(cams), "decomposition missing")
    print(f"slice: {len(cams)} frames via render() + {len(cams)} via "
          f"render_pixels (decomposition), {rasterize_calls} rasterize calls, "
          f"{launches} kernel launches", flush=True)
    print("frame ms (render(), host clock, synchronised): "
          + " ".join(f"{x:.2f}" for x in frame_ms)
          + f" | median {np.median(frame_ms):.2f} ({card})", flush=True)
    splits = [frame_stages(torch, cam, pool, deform, pipe, bg, aabb, cfg)[0]
              for cam in cams]
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    print("stage ms (median of the 6 frames, CUDA events): "
          + " ".join(f"{k}={v:.3f}" for k, v in split.items())
          + f" ({card})", flush=True)

    # 5. small scene: GPU vs CPU (plain compositor) through render()
    small_cfg = RasterConfig(max_visible=4096, pair_budget=1 << 16)
    small_pool = make_scene(torch, dev, 3000, 4096, seed=2)
    cpu_pool = copy.copy(small_pool)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "alive"):
        setattr(cpu_pool, f, getattr(small_pool, f).cpu())
    cpu_deform = copy.deepcopy(deform).cpu()
    worst = 0.0
    for yaw in (0.0, 40.0):
        cam_g = rig_camera(torch, dev, yaw, 0.5, 96, 160)
        cam_c = rig_camera(torch, "cpu", yaw, 0.5, 96, 160)
        g = render(cam_g, small_pool, deform, pipe, bg, aabb, 3, cfg=small_cfg)
        c = render(cam_c, cpu_pool, cpu_deform, pipe, bg.cpu(), aabb.cpu(), 3,
                   cfg=small_cfg)
        for k in ("render", "depth"):
            a, b = g[k].cpu().double(), c[k].double()
            err = (a - b).abs()
            check(bool((err <= RGBD_ATOL + RGBD_RTOL * b.abs()).all()),
                  f"small scene {k} GPU vs CPU: max abs {float(err.max())}")
            worst = max(worst, float(err.max()))
        check(int(g["raster_aux"]["n_pairs"]) > 0, "small scene: no pairs")
    print(f"reference: small scene (3000 gaussians, 96x160) GPU vs CPU plain "
          f"path max abs err {worst:.3e}", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    ms, plain_ms = times["view"]
    print(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "s3gaussian_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "s3gaussian_tpu/ops/tile_kernels.py:211",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
