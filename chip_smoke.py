#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``s3gaussian_tpu_torch``) on one
NVIDIA Hopper GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, a few lines of output each (any failure exits non-zero before the
last line):

  1. the card (``nvidia-smi`` name and power limit), capability 9.0;
  2. build both CUDA compositors from ``s3gaussian_tpu_torch/csrc`` (one
     ``nvcc`` each, in parallel), with ptxas registers and spills;
  3. each kernel vs its plain PyTorch version on the sorted pair stream of
     one full-width view and of a high-opacity variant (early exit), with
     the tolerances of ``tests/test_tile_kernels.py``, and both times
     beside the launch geometry (pixels per thread, threads, batch, shared
     bytes), the work counted on the stream, among it the warp-pairs with
     a contributor (the backward's reductions), and each kernel's bound
     for that work.  The backward's
     cotangent is the gradient of the train step's loss with respect to
     the compositor output;
  4. the render path: the headline scene of ``bench.py`` (200,000
     LiDAR-like Gaussians in a 204,800 pool, SH degree 3, default
     deformation field) rendered at 640x960 through ``render()`` for 3 rig
     cameras x 2 times and through ``eval.video.render_pixels`` (two rigs
     through ``render_multicam`` with the decomposition, two flow renders
     a camera), launch counts checked against the rasterize calls;
     per-frame times and a split by stage;
  5. the training slice, the main path: ``init_state`` on that scene, then
     2 coarse and 5 fine ``train_step``s against bench.py's random RGB and
     LiDAR-depth targets, launch counts checked; per-step times, a
     forward / backward / optimizer split and peak device memory;
  5b. the rig step (bench.py's ``detail_multicam3``): the headline scene
     trained a rig of 3 cameras (yaw -40/0/+40, one time) a step through
     ``train_step_multicam``, one forward and one backward launch a
     camera; ms a step (median of 5), cameras/s beside the single-camera
     step's, the forward / backward / optimizer split, peak memory;
  6. a small scene on the GPU and on the CPU (plain compositors): renders
     and one fine train step from the same state, which must agree, every
     pixel of the renders within tolerance; the renders again with the
     field phase 5 trained, where a pixel may differ only through a pair
     on a skip or exit threshold, which is shown; then (6b) a rig step
     with the union cull and two-class emission from one mid-training
     state, held to the same train-step tolerances;
  6c. the Waymo rig at full width (bench.py's ``detail_waymo_rig``): the
     street360 cloud of 1.5 M points in a 1,507,328 pool, 3 cameras
     yawed 40 degrees apart, the union cull to 589,824 rows, two-class
     emission (``big_budget`` 131,072), pair budget 2^23; a few rig
     steps: ms a step, cameras/s, peak memory, n_pairs, the working set,
     the overflow counters (pairs and visible gated at 0);
  7. the training CLI, the main path: a synthetic Waymo-layout clip (10
     frames x 3 cameras at 640x960, ground truth rendered from a known
     street scene of ~344k Gaussians with the port's rasterizer, 60,000
     LiDAR points a frame) under the ignored ``build/``, trained by
     ``train_cli.main`` with the default model and optimizer and only
     depth and cadence cut (60 coarse + 120 fine steps, density control
     every 20, opacity reset every 60): every logged loss finite, no
     budget overflow, clones or splits and prunes, the opacity resets,
     the fit improving, one forward and one backward launch per step, the
     final checkpoint and PLY consistent; reader seconds, it/s per stage,
     ``densify_step`` ms, checkpoint save ms and peak memory.  Then the
     final eval sweep of the same call, with the committed LPIPS fixture
     weights (``S3G_LPIPS_WEIGHTS``), over the train and full splits (30
     cameras each, 10 rigs): a metrics JSON per split with the JAX
     package's keys, finite psnr/ssim, a float lpips, the masked metrics,
     one frame per camera of every frame key, the videos or PNGs written,
     no render beyond its budgets, 3 compositor launches per camera and 2
     per flow render; seconds per split, render rates, video writing
     seconds, peak memory.  Then SSIM, masked SSIM and LPIPS of one sweep
     frame on the card with TF32 switched on globally against the CPU in
     float64 (LPIPS float32), atol 1e-5, and each metric's ms per view;
  8. ``--eval_only`` on phase 7's model path: it restores the final fine
     checkpoint, its sweep holds phase 7's gates and reproduces its
     per-view metrics within 1e-6; on a fresh model path it refuses
     ("no checkpoint");
  9. the ``arguments/waymo_perf.py`` preset through ``train_cli.main``
     on phase 7's clip with its cadence (40 coarse + 80 fine rig steps
     of 3 cameras, the cull, the auto-sized ``max_visible``) and its
     final eval sweep: phase 7's gates with 3 forward and 3 backward
     launches a rig step, the printed budget and ``check_sweep``'s
     gates; it/s and cameras/s per stage.

Then the compositor launches of every phase that drives the port's
paths (4, 5, 5b, 6c, 7, 8, 9; not the comparisons of 3, 6 and 6b), one
JSON line with both kernels (their launches summed over those phases),
the script's wall time, the card line, and last ``{"ok": true,
"device": {...}}``.  The port imports no jax; neither does this script.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

H, W = 640, 960
N_GAUSSIANS = 200_000
CAPACITY = 204_800
TIMES = (0.4, 0.6)
YAWS_DEG = (-40.0, 0.0, 40.0)
SPATIAL_LR_SCALE = 30.0          # bench.py's headline
COARSE_STEPS, FINE_STEPS, SPLIT_STEPS = 2, 5, 3
# tests/test_tile_kernels.py:46-49 (forward) and :91-93 (backward)
RGBD_ATOL, RGBD_RTOL, FINAL_T_ATOL, N_CONTRIB_ATOL = 5e-4, 1e-4, 2e-4, 1.0
BWD_ATOL_SCALE, BWD_RTOL = 1e-5, 1e-4
# GPU vs CPU train step on the small scene: loss rtol; each tensor's
# update (after - before) atol 1e-3·max|update| and rtol 1e-2 — the
# bfloat16 plane gradients round once per cell, and a cell whose f32 sum
# lands on a rounding boundary moves by one bf16 step (0.4%) in one of
# the two
STEP_LOSS_RTOL, STEP_ATOL_SCALE, STEP_RTOL = 1e-4, 1e-3, 1e-2
# H100 SXM datasheet peaks: HBM bytes/s; float32 outside the tensor
# cores 67 TFLOP/s, which counts an FMA as two operations, so the card
# issues 33.5 T float32 instructions a second, an FMA or a lone add,
# multiply or min alike
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
# float32 instructions the compositor's function needs, in the factored
# form of csrc/composite_bwd.cu (terms of dx alone once per column, the
# conic once per pair); exp and division counted as one each (each takes
# several), compares and selects not counted, so this is a lower bound:
#   per (column, pair) that a pixel of the column evaluates: dx 1 +
#     conic_dx 3 = 4;
#   per evaluated pixel-pair: dy 1 + conic_power 6 + exp 1 + alpha (mul,
#     min) 2 = 10, no FMA among them (the _rn operations never contract);
#   forward, per contributing pixel-pair: test_T 2 + w 1 + rgb/depth 4 +
#     sum_w 1 + n_contrib 1 = 9, of which the 4 rgb/depth are FMAs;
#   backward, per contributing pixel-pair: test_T 2 + w 1 + e 4 + prefix
#     1 + d_alpha 3 + d_power 2 + the sums of d_power (1, dy, dy^2) 4 +
#     opacity 1 + rgb/depth 4 = 22, of which 12 are FMAs (e 4, prefix 1,
#     d_alpha 1, the dy^2 sum 1, opacity 1, rgb/depth 4); per (column,
#     pair) that a pixel of the column contributes to: the sums' dx
#     products 3.  The last pass, 7 per pair, is left out.
COLUMN_OPS, ALPHA_OPS, FWD_BLEND_OPS = 4, 10, 9
BWD_BLEND_OPS, BWD_COLUMN_OPS = 22, 3
# a GPU-vs-CPU pixel difference is put down to a pair on a threshold when
# the pair's power, alpha or transmittance lies within this share of the
# threshold on both devices (power: within this of 0)
FLIP_MARGIN = 1e-3
# the trained-field renders of phase 6: pixels beyond tolerance allowed
# per view, each shown to come from a threshold flip
MAX_FLIPPED_PIXELS = 32
# shuffles per warp-pair of the backward's reduction
# (csrc/composite_bwd.cu::warp_reduce_scatter)
REDUCE_SHUFFLES = 12

# phase 7: the clip (scripts/mini_clip.py's street scene at density 4,
# its camera rig and poses) and the CLI's cuts, depth and cadence only
CLIP_FRAMES, CLIP_DENSITY, CLIP_LIDAR, CLIP_SEED = 10, 4.0, 60_000, 0
CAM_YAWS = (0.0, 0.785, -0.785)
CLI_COARSE, CLI_FINE, CLI_LOG_EVERY = 60, 120, 10
CLI_DENSIFY_FROM, CLI_DENSIFY_EVERY, CLI_RESET, CLI_CKPT = 20, 20, 60, 100

# the init cloud after the reader's voxel dedup and aabb clip, and the
# pool capacity load_scene gives it: min(max(next_pow2(1.5 n), 2^16), 2^21)
INIT_CLOUD_RANGE, CLI_CAPACITY = (175_000, 349_000), 1 << 19
# the eval sweep of phases 7-8: the clip has no test split at stride 0;
# the metrics JSON keys of the JAX package's sweep; the frame lists a
# split returns one per camera; the render overflow counts gated (the
# rect clamp is printed, as in training); the metric check's atol
SWEEP_SPLITS = ("train", "full")
METRIC_KEYS = {"psnr", "ssim", "masked_psnr", "masked_ssim", "lpips"}
SWEEP_FRAMES = ("rgbs", "gt_rgbs", "depths", "dynamic_rgbs", "static_rgbs",
                "forward_flows", "backward_flows")
SWEEP_OVERFLOW = ("overflow_rect", "overflow_visible", "overflow_pairs")
METRIC_ATOL = 1e-5
LPIPS_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                             "lpips_alex_fixture.npz")
# the CLI's device memory after a step may not grow across the fine stage
# by more than this share (densify replaces tensors, never adds rows)
ALLOC_GROWTH = 0.05

# phase 5b: bench.py's detail_multicam3 rig on the headline scene (its
# 3 cameras yawed as the Waymo rig's), steps after warm-up, timed
RIG_WARMUP, RIG_STEPS = 2, 5
# phase 6c: bench.py's detail_waymo_rig, the street360 cloud at the
# reference's 1.5 M LiDAR cap, the forward rig culled by its union
WAYMO_N, WAYMO_CAP, WAYMO_MAX_VISIBLE = 1_500_000, 1_507_328, 589_824
WAYMO_BIG_BUDGET, WAYMO_PAIR_BUDGET = 131_072, 1 << 23
WAYMO_WARMUP, WAYMO_STEPS = 1, 3
# phase 9: arguments/waymo_perf.py on phase 7's clip, depth cut further
# (rig steps of 3 cameras), phase 7's cadence
PERF_COARSE, PERF_FINE = 40, 80


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
    sized by create_from_pcd's 3-NN rule.  Returns the pool and the
    generator, advanced as bench.py's is before it draws the targets."""
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    rng = np.random.default_rng(seed)
    tan = np.tan(0.5)
    z = rng.uniform(1.0, 60.0, n)
    pts = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                    rng.uniform(-0.9, 0.9, n) * tan * z, z],
                   1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return create_from_pcd(pts, cols, cap, device=dev), rng


def rig_camera(torch, dev, yaw_deg, t, h, w, image=None, depth_map=None):
    """A rig camera at the ego centre looking along ``yaw`` (bench.py's
    FRONT_LEFT / FRONT / FRONT_RIGHT geometry); yaw 0 is bench.py's
    headline camera."""
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.ops.transforms import projection_matrix
    yaw = math.radians(yaw_deg)
    cy, sy = math.cos(yaw), math.sin(yaw)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]],
                            np.float32)
    full = (view @ projection_matrix(0.01, 100.0, 1.0, 1.0).T).astype(
        np.float32)

    def t_(x):
        return None if x is None else torch.tensor(x, device=dev)

    return Camera(world_view=t_(view), full_proj=t_(full),
                  campos=torch.zeros(3, device=dev),
                  time=torch.tensor(t, dtype=torch.float32, device=dev),
                  fovx=1.0, fovy=1.0, image_height=h, image_width=w,
                  image=t_(image), depth_map=t_(depth_map))


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


def fine_stream(torch, cam, pool, deform, bg, aabb, cfg,
                mark=lambda: None):
    """render()'s fine path up to the compositor, on the device of
    ``pool``: (sorted pair stream, tile_starts, gx, gy).  ``mark()`` is
    called before the deformation and after it, the projection and the
    sort."""
    from s3gaussian_tpu_torch.ops import rasterizer as rz
    from s3gaussian_tpu_torch.ops.project import sh_to_color
    from s3gaussian_tpu_torch.render.renderer import make_settings
    with torch.no_grad():
        mark()
        shs = pool.get_features()
        d = deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity, shs,
                   cam.time.reshape(()), aabb)
        mark()
        settings = make_settings(cam, bg, 3)
        colors = sh_to_color(d.shs, pool.xyz, cam.campos, 3)
        rot = d.rotations / torch.linalg.norm(d.rotations, dim=-1,
                                              keepdim=True)
        _, pk, feat_pool = rz.project_and_key(
            settings, d.xyz, torch.sigmoid(d.opacity)[:, 0],
            scales=torch.exp(d.scales), rotations=rot, colors_precomp=colors,
            alive=pool.alive, cfg=cfg)
        mark()
        gx, gy = rz.grid_dims(settings, cfg)
        stream, tile_starts, _, _ = rz.sort_stream(
            feat_pool, pk, gx * gy, cfg.rect_cap, cfg.pair_budget)
        mark()
    return stream, tile_starts, gx, gy


def frame_stages(torch, cam, pool, deform, pipe, bg, aabb, cfg):
    """render()'s fine path split into its stages with CUDA events between
    them.  Returns (ms per stage, [T,8,P] compositor output, stream,
    tile_starts)."""
    from s3gaussian_tpu_torch.ops.tile_kernels import composite_fwd
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    marks = iter(ev)
    stream, tile_starts, gx, gy = fine_stream(
        torch, cam, pool, deform, bg, aabb, cfg,
        mark=lambda: next(marks).record())
    with torch.no_grad():
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


def compare_pair_grads(got, want, n_pairs):
    """Backward kernel vs plain [16, M] at the tolerance of
    tests/test_tile_kernels.py:91-93; exact zeros where nothing is
    written.  Returns the max abs error over the first n_pairs columns."""
    g, w = got[:, :n_pairs].double(), want[:, :n_pairs].double()
    err = (g - w).abs()
    scale = max(float(w.abs().max()), 1e-30)
    bad = err > BWD_ATOL_SCALE * scale + BWD_RTOL * w.abs()
    check(not bool(bad.any()),
          f"pair gradients differ at {int(bad.sum())} entries: max abs "
          f"{float(err.max()):.3e}, scale {scale:.3e}")
    check(bool((got[:, n_pairs:] == 0).all()),
          "gradients past n_pairs are not zero")
    check(bool((got[10:] == 0).all()), "gradient rows 10-15 are not zero")
    return float(err.max())


def step_loss_cotangent(torch, out, gt, gt_depth, opt, gx, gy, cfg):
    """The gradient of the train step's image and depth terms (the only
    terms that read the compositor) with respect to the compositor output
    ``out`` [T, 8, P]; rows 5-7 come out 0."""
    from s3gaussian_tpu_torch.ops.composite import unpack_tiles
    from s3gaussian_tpu_torch.train.losses import depth_loss, l1_loss, ssim
    leaf = out.detach().requires_grad_(True)
    maps = unpack_tiles(leaf, H, W, gx, gy, cfg.tile_x, cfg.tile_y)
    color = maps["rgb"]                                  # bg is black
    img = gt.permute(2, 0, 1)
    loss = (l1_loss(color, img) + opt.lambda_dssim * (1.0 - ssim(color, img))
            + opt.lambda_depth * depth_loss(maps["depth"], gt_depth))
    (dout,) = torch.autograd.grad(loss, [leaf])
    return dout.contiguous()


def work_counts(torch, stream, tile_starts, gx, gy, tx, ty, groups,
                chunk=128):
    """What a compositor must do on this stream, counted as the plain
    version composites it: the pixel-pairs evaluated (a pixel evaluates
    its tile's pairs until the one that saturates it, inclusive), the
    pairs that must be read (per tile, the most any of its pixels
    evaluates) and, for each pixel-to-group map in ``groups`` ([P] group
    of each pixel: a warp, a column), the (group, pair)s in which some
    pixel evaluates and in which some pixel contributes.  The forward
    output's row 5 counts the contributing pixel-pairs."""
    from s3gaussian_tpu_torch.ops import composite as comp
    dev = stream.device
    starts = tile_starts[:-1].long()
    counts = tile_starts[1:].long() - starts
    px, py = comp.tile_pixel_coords(gx, gy, tx, ty, dev)
    evaluated = torch.zeros(gx * gy, tx * ty, device=dev)
    onehot = {k: torch.nn.functional.one_hot(w).float()
              for k, w in groups.items()}
    group_pairs = {k: {"evaluating": 0, "contributing": 0} for k in groups}
    t = torch.ones(gx * gy, 1, tx * ty, device=dev)
    lane = torch.arange(chunk, device=dev)
    with torch.no_grad():
        for ci in range(-(-int(counts.max()) // chunk)):
            valid = (ci * chunk + lane)[None, :] < counts[:, None]
            idx = torch.where(valid, starts[:, None] + ci * chunk + lane, 0)
            f = stream[:, idx]
            dx = f[comp.FX][..., None] - px
            dy = f[comp.FY][..., None] - py
            power = (-0.5 * (f[comp.FCA][..., None] * dx * dx
                             + f[comp.FCC][..., None] * dy * dy)
                     - f[comp.FCB][..., None] * dx * dy)
            alpha = torch.clamp(f[comp.FOP][..., None] * torch.exp(power),
                                max=comp.ALPHA_MAX)
            am = torch.where((power > 0) | (alpha < comp.ALPHA_MIN)
                             | ~valid[..., None], 0.0, alpha)
            cum_incl = t * torch.cumprod(1.0 - am, dim=1)
            before = cum_incl / (1.0 - am)
            evals = (before >= comp.T_EPS) & valid[..., None]
            evaluated += evals.sum(1)
            contrib = (cum_incl >= comp.T_EPS) & (am > 0)
            for k, oh in onehot.items():
                for what, mask in (("evaluating", evals),
                                   ("contributing", contrib)):
                    group_pairs[k][what] += int(((mask.float() @ oh) > 0)
                                                .sum())
            t = cum_incl[:, -1:]
    return int(evaluated.sum()), int(evaluated.amax(1).sum()), group_pairs


def pixel_groups(torch, tk, geometry, tx, ty, dev):
    """[P] group of each pixel of a tile: its warp under ``geometry``
    ("launch") and with one thread per pixel ("one_per_thread"), and its
    column ("column")."""
    slots = tk.pixel_slots(geometry, tx, ty)                # [threads, ppt]
    thread = torch.arange(slots.shape[0])[:, None].expand_as(slots)
    launch = torch.empty(tx * ty, dtype=torch.int64)
    owned = slots >= 0
    launch[slots[owned]] = thread[owned] // 32
    pixel = torch.arange(tx * ty, device=dev)
    return {"launch": launch.to(dev), "one_per_thread": pixel // 32,
            "column": pixel % tx}


def geometry_str(g, smem_bytes):
    return (f"{g.pixels_per_thread} pixels/thread, {g.threads} threads, "
            f"batch {g.batch}, {smem_bytes} B shared")


def ptxas_summary(log):
    """``nvcc -Xptxas -v`` output -> "kernel: R registers, S spill
    bytes" for each kernel."""
    lines, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"(composite_[a-z]+_kernel)", ln)
        if "entry function" in ln and m:
            name = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m[1]}+{m[2]} spill bytes"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            lines.append(f"{name}: {m[1]} registers, {spill}")
            name = None
    return lines


def pixel_trace(torch, stream, tile_starts, tile, px, py):
    """The plain compositor's arithmetic for pixel (px, py) of ``tile``, on
    the CPU in float32: per pair of the tile its x, y and depth, power,
    alpha, the transmittance after it and whether it contributes."""
    from s3gaussian_tpu_torch.ops import composite as comp
    f = stream[:, int(tile_starts[tile]):int(tile_starts[tile + 1])].cpu()
    dx, dy = f[comp.FX] - px, f[comp.FY] - py
    power = (-0.5 * (f[comp.FCA] * dx * dx + f[comp.FCC] * dy * dy)
             - f[comp.FCB] * dx * dy)
    alpha = torch.clamp(f[comp.FOP] * torch.exp(power), max=comp.ALPHA_MAX)
    am = torch.where((power > 0) | (alpha < comp.ALPHA_MIN), 0.0, alpha)
    t_after = torch.cumprod(1.0 - am, 0)
    return {"xyd": torch.stack([f[comp.FX], f[comp.FY], f[comp.FD]], 1),
            "power": power, "alpha": alpha, "t_after": t_after,
            "contrib": (t_after >= comp.T_EPS) & (am > 0)}


def threshold_flips(torch, tg, tc):
    """The pairs whose decision differs between two traces of one pixel
    (pixel_trace on the GPU's and on the CPU's stream), front to back,
    pairs matched by x, y and depth: [(kind, depth, values)], kind the
    threshold that the pair's values on the two devices straddle and both
    lie within FLIP_MARGIN of ("power" > 0, "alpha" < 1/255, "T" < 1e-4),
    else "unexplained".  A flip changes the transmittance behind it, so
    only the first flip has to be on a threshold."""
    from s3gaussian_tpu_torch.ops import composite as comp
    a, b = tg["xyd"][:, None].double(), tc["xyd"][None].double()
    close = ((a - b).abs() <= 1e-4 * (1 + b.abs())).all(-1)     # [ng, nc]
    j_of = torch.where(close.any(1), close.float().argmax(1), -1)
    matched = torch.zeros(b.shape[1], dtype=torch.bool)
    matched[j_of[j_of >= 0]] = True
    flips = [("unexplained", float(tc["xyd"][j, 2]), "only in the CPU's tile")
             for j in torch.nonzero(tc["contrib"] & ~matched)[:, 0].tolist()]
    for i in range(a.shape[0]):
        j = int(j_of[i])
        depth = float(tg["xyd"][i, 2])
        if j < 0:
            if bool(tg["contrib"][i]):
                flips.append(("unexplained", depth, "only in the GPU's tile"))
            continue
        if bool(tg["contrib"][i]) == bool(tc["contrib"][j]):
            continue
        vals = {k: (float(tg[k][i]), float(tc[k][j]))
                for k in ("power", "alpha", "t_after")}
        kind = "unexplained"
        for name, key, thr in (("power", "power", 0.0),
                               ("alpha", "alpha", comp.ALPHA_MIN),
                               ("T", "t_after", comp.T_EPS)):
            g, c = vals[key]
            near = max(abs(g - thr), abs(c - thr)) <= FLIP_MARGIN * (thr or 1)
            if (g < thr) != (c < thr) and near:
                kind = name
                break
        flips.append((kind, depth, vals))
    return sorted(flips, key=lambda f: f[1])


def bound(n_bytes, n_instr):
    """Least time on the card (ms) for n_bytes of HBM traffic and n_instr
    float32 instructions, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def state_to(torch, state, dev):
    """A deep copy of a TrainState on ``dev``."""
    from s3gaussian_tpu_torch.models.pool import GaussianPool, PoolStats
    from s3gaussian_tpu_torch.train.optim import AdamState

    def tree(x):
        return {g: {k: v.to(dev, copy=True) for k, v in d.items()}
                for g, d in x.items()}

    return dataclasses.replace(
        state,
        pool=GaussianPool(**{f.name: getattr(state.pool, f.name).to(
            dev, copy=True) for f in dataclasses.fields(GaussianPool)}),
        deform=copy.deepcopy(state.deform).to(dev),
        adam=AdamState(mu=tree(state.adam.mu), nu=tree(state.adam.nu),
                       count=state.adam.count.to(dev, copy=True)),
        stats=PoolStats(*(getattr(state.stats, f.name).to(dev, copy=True)
                          for f in dataclasses.fields(PoolStats))),
        step=state.step.to(dev, copy=True), aabb=state.aabb.to(dev),
        nan_skips=state.nan_skips.to(dev, copy=True))


def snapshot(torch, state):
    """Copies of every trainable tensor, keyed (group, name)."""
    from s3gaussian_tpu_torch.train.trainer import param_tree
    return {(g, k): v.detach().clone()
            for g, d in param_tree(state.pool, state.deform).items()
            for k, v in d.items()}


def headline(torch, dev):
    """bench.py's headline workload on ``dev``: the scene, its random RGB
    and LiDAR-depth targets, the configs and the 6 rig cameras."""
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    pool, rng = make_scene(torch, dev, N_GAUSSIANS, CAPACITY)
    hp = ModelHiddenParams()
    return types.SimpleNamespace(
        pool=pool,
        gt=rng.random((H, W, 3)).astype(np.float32),       # bench.py:102-103
        gt_depth=rng.uniform(1, 70, (H, W)).astype(np.float32),
        hp=hp, opt=OptimizationParams(),
        deform=DeformationField(hp, torch.Generator().manual_seed(0), dev),
        aabb=torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                          device=dev),
        pipe=PipelineParams(),
        cfg=RasterConfig(tile_x=16, tile_y=16, max_visible=CAPACITY,
                         rect_w=4, rect_h=4, pair_budget=1 << 22, chunk=128,
                         big_budget=0, tight_rect=True),
        bg=torch.zeros(3, device=dev),
        cams=[rig_camera(torch, dev, yaw, t, H, W)
              for t in TIMES for yaw in YAWS_DEG])


def kernel_streams(torch, su):
    """The sorted pair streams the kernels are checked and timed on: the
    front camera at t = 0.4 ("view") and the same with every opacity drawn
    from [0.9, 0.99] ("high_opacity", early exits).  name -> (stream,
    tile_starts)."""
    dev = su.bg.device
    hi_pool = copy.copy(su.pool)
    op = np.random.default_rng(1).uniform(0.9, 0.99, CAPACITY)
    hi_pool.opacity = torch.tensor(np.log(op / (1 - op)), dtype=torch.float32,
                                   device=dev)[:, None]
    return {name: frame_stages(torch, su.cams[1], pool, su.deform, su.pipe,
                               su.bg, su.aabb, su.cfg)[2:]
            for name, pool in (("view", su.pool), ("high_opacity", hi_pool))}


def gt_scene(rng, density, n_ground=48_000, n_build=32_000, n_car=6_000):
    """The street of ``scripts/mini_clip.py::gt_scene`` (default car
    options), in the world (= frame-0 ego) frame, x forward, y left, z up:
    a checkered ground plane, building facades on both sides and three
    car clusters driving along x.  ``density`` scales the counts and the
    splat sigma by 1/sqrt(density)."""
    n_ground = int(n_ground * density)
    n_build = int(n_build * density)
    n_car = int(n_car * density)
    smul = float(density) ** -0.5
    gx = rng.uniform(-5, 120, n_ground)
    gy = rng.uniform(-12, 12, n_ground)
    gz = rng.normal(0.0, 0.02, n_ground)
    checker = ((np.floor(gx / 2) + np.floor(gy / 2)) % 2)
    g_col = np.stack([0.25 + 0.4 * checker, 0.25 + 0.3 * checker,
                      0.25 + 0.1 * checker], 1)
    g_scale = np.full((n_ground, 3), 0.14 * smul)
    g_scale[:, 2] = 0.02 * smul
    bx = rng.uniform(0, 120, n_build)
    side = np.sign(rng.uniform(-1, 1, n_build))
    by = side * rng.uniform(13, 16, n_build)
    bz = rng.uniform(0, 8, n_build)
    hue = (np.floor(bx / 15) % 3)
    b_col = np.clip(np.stack([0.3 + 0.2 * (hue == 0) + 0.25 * np.sin(bz / 3),
                              0.3 + 0.2 * (hue == 1) + 0.1 * np.cos(bx / 7),
                              0.3 + 0.2 * (hue == 2)], 1), 0, 1)
    b_scale = np.full((n_build, 3), 0.16 * smul)
    n_per = n_car // 3
    vel = np.zeros((n_ground + n_build + n_per * 3, 3))
    pts_c, col_c = [], []
    for i, ((cx, cy), col, v) in enumerate(zip(
            [(25, 4), (60, -4), (40, 0)],
            [(0.8, 0.1, 0.1), (0.1, 0.2, 0.8), (0.9, 0.8, 0.2)],
            [(4.0, 0.0), (-3.0, 0.0), (5.0, 0.0)])):       # m per frame
        pts_c.append(np.stack([cx + rng.uniform(-2.2, 2.2, n_per),
                               cy + rng.uniform(-1.0, 1.0, n_per),
                               0.4 + rng.uniform(0, 1.4, n_per)], 1))
        col_c.append(np.tile(np.asarray(col), (n_per, 1)))
        lo = n_ground + n_build + i * n_per
        vel[lo:lo + n_per, :2] = v
    c_scale = np.full((n_per * 3, 3), 0.12 * smul)
    pts = np.concatenate([np.stack([gx, gy, gz], 1),
                          np.stack([bx, by, bz], 1)] + pts_c, 0)
    n = len(pts)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return dict(pts=pts.astype(np.float32),
                cols=np.concatenate([g_col, b_col] + col_c, 0).astype(
                    np.float32),
                scales=np.concatenate([g_scale, b_scale, c_scale], 0).astype(
                    np.float32),
                quats=quats, opac=np.full((n,), 0.9, np.float32),
                vel=vel.astype(np.float32))


def write_clip(torch, dev, out, scene, rng, n_frames, h, w, lidar_cap,
               cfg=None, ego_step=2.0):
    """The Waymo layout of ``scripts/mini_clip.py::write_clip``: calibration
    at the original 1280x1920 scale, ego poses driving along x, LiDAR rows
    sampled from the frame's Gaussian centres (the ground-label column is
    left 0: the reader does not read it), ground-truth images rendered
    from the known scene with the port's ``rasterize`` on ``dev`` and
    written as PNG content under the reader's ``.jpg`` names, dynamic
    masks and ``frame_info.json``.  Returns the renders' overflow counts
    and the LiDAR rows written."""
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.data.images import write_png
    from s3gaussian_tpu_torch.data.waymo import OPENCV2DATASET, ORIGINAL_SIZE
    from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings, rasterize
    from s3gaussian_tpu_torch.ops.transforms import (focal2fov,
                                                     full_projection,
                                                     projection_matrix)

    for d in ("images", "intrinsics", "extrinsics", "ego_pose", "lidar",
              "dynamic_masks"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    fx0 = fy0 = 2080.0
    cx0, cy0 = ORIGINAL_SIZE[0][1] / 2, ORIGINAL_SIZE[0][0] / 2
    cam_to_egos = []
    for i, yaw in enumerate(CAM_YAWS):
        np.savetxt(os.path.join(out, "intrinsics", f"{i}.txt"),
                   np.array([fx0, fy0, cx0, cy0, 0, 0, 0, 0, 0]))
        c, s = np.cos(yaw), np.sin(yaw)
        c2e = np.array([[c, -s, 0, 1.5], [s, c, 0, 0.0],
                        [0, 0, 1, 2.0], [0, 0, 0, 1.0]])
        np.savetxt(os.path.join(out, "extrinsics", f"{i}.txt"), c2e)
        cam_to_egos.append(c2e @ OPENCV2DATASET)
    fx, fy = fx0 * w / ORIGINAL_SIZE[0][1], fy0 * h / ORIGINAL_SIZE[0][0]
    fovx, fovy = focal2fov(fx, w), focal2fov(fy, h)
    proj = projection_matrix(0.01, 100.0, fovx, fovy)
    n = len(scene["pts"])
    cfg = cfg or RasterConfig(max_visible=n, rect_w=6, rect_h=6,
                              pair_budget=1 << 23)

    def t_(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    scales, quats, opac, cols = (t_(scene[k]) for k in ("scales", "quats",
                                                        "opac", "cols"))
    moving = np.abs(scene["vel"]).sum(1) > 0
    overflow = {"overflow_rect": 0, "overflow_visible": 0, "overflow_pairs": 0}
    n_lidar = 0
    for t in range(n_frames):
        ego = np.eye(4)
        ego[0, 3] = ego_step * t
        np.savetxt(os.path.join(out, "ego_pose", f"{t:03d}.txt"), ego)
        means_t = scene["pts"] + scene["vel"] * t
        pts_ego = means_t - ego[:3, 3]
        keep = np.where((pts_ego[:, 0] > -2) & (pts_ego[:, 0] < 80))[0]
        sub = rng.choice(keep, min(lidar_cap, len(keep)), replace=False)
        rows = np.zeros((len(sub), 10), np.float32)
        rows[:, 3:6] = pts_ego[sub]
        rows.tofile(os.path.join(out, "lidar", f"{t:03d}.bin"))
        n_lidar += len(sub)
        means = t_(means_t)
        for ci in range(len(CAM_YAWS)):
            c2w = ego @ cam_to_egos[ci]
            w2c = np.linalg.inv(c2w)
            settings = RasterSettings(
                h, w, float(np.tan(fovx / 2)), float(np.tan(fovy / 2)),
                torch.zeros(3, device=dev), 1.0, t_(w2c.T),
                t_(full_projection(w2c, proj)), 0, t_(c2w[:3, 3]))
            with torch.no_grad():
                color, _, _, aux = rasterize(settings, means, opac,
                                             scales=scales, rotations=quats,
                                             colors_precomp=cols, cfg=cfg)
            for k in overflow:
                overflow[k] += int(aux[k])
            img = torch.clamp(color, 0, 1).permute(1, 2, 0).cpu().numpy()
            write_png(os.path.join(out, "images", f"{t:03d}_{ci}.jpg"),
                      (img * 255).astype(np.uint8), level=1)
            # dynamic mask: the moving centres projected, dilated to blobs
            mask = np.zeros((h, w), np.uint8)
            pc = w2c[:3, :3] @ means_t[moving].T + w2c[:3, 3:4]
            ok = pc[2] > 0.2
            u = (fx * pc[0][ok] / pc[2][ok] + w / 2).astype(int)
            v = (fy * pc[1][ok] / pc[2][ok] + h / 2).astype(int)
            inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            for du in range(-4, 5):
                for dv in range(-4, 5):
                    mask[np.clip(v[inb] + dv, 0, h - 1),
                         np.clip(u[inb] + du, 0, w - 1)] = 255
            write_png(os.path.join(out, "dynamic_masks", f"{t:03d}_{ci}.png"),
                      mask, level=1)
    with open(os.path.join(out, "frame_info.json"), "w") as f:
        json.dump({"frames": n_frames, "source": "chip_smoke_synthetic"}, f)
    return overflow, n_lidar


def new_record():
    """What the hooks of ``cli_hooks`` record over one CLI run."""
    return {"reader_s": None, "scene": None, "densify_ms": [], "save_ms": [],
            "alloc": [], "evals": [], "splits": [], "rig_s": [], "flow_s": [],
            "video_s": [], "ovf": dict.fromkeys(SWEEP_OVERFLOW, 0),
            "pair": None, "train_launches": None, "train_peak": None}


@contextlib.contextmanager
def cli_hooks(torch, rec):
    """Timing and counting wrappers around what ``train_cli.main`` and its
    eval sweep call, the environment the run reads (the log cadence, the
    LPIPS fixture weights); all restored afterwards."""
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.eval import video
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import checkpoints as ckpt

    targets = {(train_cli, "load_scene"), (train_cli, "densify_step"),
               (train_cli, "train_step"), (train_cli, "train_step_multicam"),
               (train_cli, "do_evaluation"),
               (ckpt, "save_checkpoint"), (video, "render_pixels"),
               (video, "render_multicam"), (video, "render"),
               (video, "save_videos")}
    orig = {name: getattr(mod, name) for mod, name in targets}

    def load_scene(*a, **k):
        t = time.perf_counter()
        sc = orig["load_scene"](*a, **k)
        torch.cuda.synchronize()
        rec["reader_s"], rec["scene"] = time.perf_counter() - t, sc
        return sc

    def densify_step(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = orig["densify_step"](*a, **k)
        ev[1].record()
        torch.cuda.synchronize()
        rec["densify_ms"].append(ev[0].elapsed_time(ev[1]))
        return res

    def counted_step(name):
        def step(state, cam, stage, *a, **k):
            res = orig[name](state, cam, stage, *a, **k)
            rec["alloc"].append((stage, torch.cuda.memory_allocated()))
            return res
        return step

    def save_checkpoint(*a, **k):
        t = time.perf_counter()
        path = orig["save_checkpoint"](*a, **k)
        rec["save_ms"].append((time.perf_counter() - t) * 1e3)
        return path

    def do_evaluation(*a, **k):
        torch.cuda.synchronize()
        if rec["train_launches"] is None:
            rec["train_launches"] = (tk.launches, tk.bwd_launches)
            rec["train_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        l0 = (tk.launches, tk.bwd_launches)
        t = time.perf_counter()
        res = orig["do_evaluation"](*a, **k)
        torch.cuda.synchronize()
        rec["evals"].append({
            "step": k["step"], "stage": a[9], "results": res,
            "s": time.perf_counter() - t,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": (tk.launches - l0[0], tk.bwd_launches - l0[1])})
        return res

    def render_pixels(cams, *a, **k):
        t = time.perf_counter()
        frames = orig["render_pixels"](cams, *a, **k)
        torch.cuda.synchronize()
        rec["splits"].append({
            "n": len(cams), "s": time.perf_counter() - t,
            "frames": {key: len(v) for key, v in frames.items()
                       if isinstance(v, list)},
            "metrics": frames.get("metrics"),
            "per_view": frames.get("metrics_per_view")})
        return frames

    def timed_render(fn, times):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pkg = fn(*a, **k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            for key in SWEEP_OVERFLOW:
                rec["ovf"][key] = max(rec["ovf"][key],
                                      int(pkg["raster_aux"][key]))
            if fn is orig["render_multicam"] and rec["pair"] is None:
                # the first sweep frame whose dynamic mask has pixels, in
                # float32, and its camera, for the metric check on the card
                for b, cam in enumerate(a[0]):
                    if bool(cam.dynamic_mask.any()):
                        rec["pair"] = (pkg["render"][b].clone(), cam)
                        break
            return pkg
        return wrapped

    def save_videos(*a, **k):
        t = time.perf_counter()
        orig["save_videos"](*a, **k)
        rec["video_s"].append(time.perf_counter() - t)

    hooks = {"load_scene": load_scene, "densify_step": densify_step,
             "train_step": counted_step("train_step"),
             "train_step_multicam": counted_step("train_step_multicam"),
             "save_checkpoint": save_checkpoint,
             "do_evaluation": do_evaluation, "render_pixels": render_pixels,
             "render_multicam": timed_render(orig["render_multicam"],
                                             rec["rig_s"]),
             "render": timed_render(orig["render"], rec["flow_s"]),
             "save_videos": save_videos}
    env = {"S3G_LOG_EVERY": str(CLI_LOG_EVERY),
           "S3G_LPIPS_WEIGHTS": LPIPS_FIXTURE}
    env_before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    for mod, name in targets:
        setattr(mod, name, hooks[name])
    try:
        yield
    finally:
        for mod, name in targets:
            setattr(mod, name, orig[name])
        for k, v in env_before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def check_sweep(torch, rec, out, step, card, tag):
    """Gates of the one eval sweep ``rec`` holds (the train and full
    splits of the clip) and its printed numbers.  Returns {split:
    per-view metrics} and the sweep's compositor launches."""
    ev = rec["evals"][-1]
    n_cams = CLIP_FRAMES * len(CAM_YAWS)
    check(ev["step"] == step and ev["stage"] == "fine",
          f"{tag}: sweep at {ev['stage']} {ev['step']}, not fine {step}")
    check(set(ev["results"]) == set(SWEEP_SPLITS),
          f"{tag}: sweep splits {sorted(ev['results'])}")
    mdir = os.path.join(out, "eval", "metrics")
    per_view = {}
    for split, sp in zip(SWEEP_SPLITS, rec["splits"][-len(SWEEP_SPLITS):]):
        files = [f for f in os.listdir(mdir)
                 if f.startswith(f"{step}_images_{split}_")]
        check(len(files) >= 1, f"{tag}: no metrics JSON for {split}")
        with open(os.path.join(mdir, sorted(files)[-1])) as f:
            m = json.load(f)
        check(set(m) == METRIC_KEYS, f"{tag} {split}: JSON keys {sorted(m)}")
        check(all(isinstance(m[k], float) and math.isfinite(m[k])
                  for k in METRIC_KEYS),
              f"{tag} {split}: metrics {m}")
        check(m == ev["results"][split], f"{tag} {split}: JSON differs")
        check(sp["n"] == n_cams and all(
            sp["frames"].get(k) == n_cams for k in SWEEP_FRAMES),
            f"{tag} {split}: frames {sp['frames']} for {sp['n']} cameras")
        vdir = os.path.join(out, "eval", f"{split}_set_{step}")
        written = set(os.listdir(vdir))
        for key in SWEEP_FRAMES:
            pngs = {f"{key}_{i:03d}.png" for i in range(CLIP_FRAMES)}
            check(f"{key}.mp4" in written or pngs <= written,
                  f"{tag} {split}: no video or PNGs of {key}")
        per_view[split] = sp["per_view"]
    check(rec["ovf"]["overflow_visible"] == rec["ovf"]["overflow_pairs"] == 0,
          f"{tag}: a sweep render overflowed its budget: {rec['ovf']}")
    n_rig, n_flow = len(rec["rig_s"]), len(rec["flow_s"])
    want_launches = len(SWEEP_SPLITS) * n_cams * 5
    check(n_rig == len(SWEEP_SPLITS) * CLIP_FRAMES
          and n_flow == len(SWEEP_SPLITS) * n_cams * 2,
          f"{tag}: {n_rig} rig and {n_flow} flow renders")
    check(ev["launches"] == (want_launches, 0),
          f"{tag}: {ev['launches']} forward/backward launches in the sweep, "
          f"not ({want_launches}, 0)")
    splits = rec["splits"][-len(SWEEP_SPLITS):]
    print(f"{tag}: eval sweep at fine {step}: " + "; ".join(
        f"{split} {sp['n']} cameras {sp['s']:.3f} s, psnr "
        f"{m['psnr']:.3f} ssim {m['ssim']:.4f} lpips {m['lpips']:.4f} "
        f"masked psnr {m['masked_psnr']:.3f} ssim {m['masked_ssim']:.4f}"
        for split, sp, m in zip(SWEEP_SPLITS, splits,
                                (ev["results"][s] for s in SWEEP_SPLITS)))
        + f"; whole sweep {ev['s']:.3f} s ({card})", flush=True)
    print(f"{tag}: sweep renders (host clock, synchronised): {n_rig} rig "
          f"renders (3 cameras x full, dynamic, static) at "
          f"{n_rig / sum(rec['rig_s']):.2f}/s, median "
          f"{np.median(rec['rig_s']) * 1e3:.2f} ms; {n_flow} flow renders at "
          f"{n_flow / sum(rec['flow_s']):.2f}/s, median "
          f"{np.median(rec['flow_s']) * 1e3:.2f} ms; video/PNG writing "
          + " + ".join(f"{x:.3f}" for x in rec["video_s"])
          + f" s; peak device memory over the sweep {ev['peak'] / 2**30:.2f} "
          f"GiB; rect-clamped {rec['ovf']['overflow_rect']} (most in a "
          f"render); {ev['launches'][0]} forward / {ev['launches'][1]} "
          f"backward compositor launches ({card})", flush=True)
    return per_view, ev["launches"]


def eval_only_phase(torch, argv, out, per_view7, card):
    """Phase 8: ``--eval_only`` on phase 7's model path restores the final
    fine checkpoint and reproduces the final sweep's per-view metrics; on
    a fresh model path it refuses.  Returns the sweep's launches."""
    from s3gaussian_tpu_torch import train_cli

    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    rec = new_record()
    t0 = time.time()
    with cli_hooks(torch, rec):
        tk.launches = tk.bwd_launches = 0
        state = train_cli.main(argv + ["--eval_only"])
        torch.cuda.synchronize()
        run_s = time.time() - t0
        fresh = os.path.join(os.path.dirname(out), "fresh")
        try:
            train_cli.main(argv[:2] + ["--model_path", fresh] + argv[4:]
                           + ["--eval_only"])
            refused = None
        except SystemExit as e:
            refused = str(e)
    check(rec["train_launches"] == (0, 0) and len(rec["evals"]) == 1,
          f"eval_only: {rec['train_launches']} launches before the sweep, "
          f"{len(rec['evals'])} sweeps")
    per_view, launches = check_sweep(torch, rec, out, int(state.step), card,
                                     "eval_only")
    worst = 0.0
    for split, want in per_view7.items():
        got = per_view[split]
        check(got.keys() == want.keys(), f"eval_only {split}: keys")
        for k in want:
            check(len(got[k]) == len(want[k]), f"eval_only {split} {k}")
            for g, w in zip(got[k], want[k]):
                err = abs(g - w)
                check(err <= 1e-6, f"eval_only {split} {k}: {g} vs the final "
                      f"sweep's {w}")
                worst = max(worst, err)
    check(refused is not None and "no checkpoint" in refused,
          f"eval_only on a fresh model path: {refused!r}")
    print(f"eval_only: restored the fine checkpoint of step "
          f"{int(state.step)}, run {run_s:.2f} s; per-view metrics equal the "
          f"final sweep's within {worst:.1e} (gate 1e-6) over "
          f"{sum(len(v['psnr']) for v in per_view.values())} views; on a "
          f"fresh model path: {refused}", flush=True)
    return launches, rec


def metrics_on_card(torch, rec, card):
    """SSIM, masked SSIM and LPIPS of one sweep frame pair on the card with
    TF32 switched on globally, against the same functions on the CPU in
    float64 (LPIPS float32); each metric's time per view."""
    from s3gaussian_tpu_torch.eval.lpips import lpips
    from s3gaussian_tpu_torch.eval.metrics import (masked_psnr, masked_ssim,
                                                   psnr, ssim_skimage)
    from s3gaussian_tpu_torch.eval.video import view_metrics

    check(rec["pair"] is not None, "no sweep frame with a dynamic mask")
    render, cam = rec["pair"]
    rgbf = torch.clamp(render, 0, 1).permute(1, 2, 0).contiguous()
    img, mask = cam.image, cam.dynamic_mask
    fns = {"psnr": lambda x, y, m: psnr(x, y),
           "ssim": lambda x, y, m: ssim_skimage(x, y),
           "masked_psnr": masked_psnr, "masked_ssim": masked_ssim,
           "lpips": lambda x, y, m: lpips(x, y)}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    env_before = os.environ.get("S3G_LPIPS_WEIGHTS")
    os.environ["S3G_LPIPS_WEIGHTS"] = LPIPS_FIXTURE
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        vals = {}
        for k in ("ssim", "masked_ssim", "lpips"):
            got = float(fns[k](rgbf, img, mask))
            cpu = [x.cpu() for x in (rgbf, img)]
            if k != "lpips":
                cpu = [x.double() for x in cpu]
            want = float(fns[k](*cpu, mask.cpu()))
            vals[k] = (got, want)
            check(abs(got - want) <= METRIC_ATOL, f"{k} on the card with "
                  f"TF32 on: {got} vs the CPU's {want}")
        ms = {k: cuda_ms(torch, lambda f=f: f(rgbf, img, mask), reps=10)
              for k, f in fns.items()}
        ms["view_metrics"] = cuda_ms(
            torch, lambda: view_metrics(render, cam), reps=10)
        check(torch.backends.cudnn.allow_tf32, "the TF32 flag was changed")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
        if env_before is None:
            del os.environ["S3G_LPIPS_WEIGHTS"]
        else:
            os.environ["S3G_LPIPS_WEIGHTS"] = env_before
    print(f"metrics on the card with TF32 on globally, one {H}x{W} sweep "
          f"frame ({int(mask.sum())} masked pixels) vs the CPU in float64 "
          f"(LPIPS float32, fixture weights): " + " ".join(
              f"{k} {g:.9f} vs {w:.9f} (err {abs(g - w):.2e})"
              for k, (g, w) in vals.items())
          + f" (gate {METRIC_ATOL}); ms per view (CUDA events, 10 reps): "
          + " ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" ({card})",
          flush=True)


def read_logger(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cli_phase(torch, dev, card):
    """Phase 7: build the clip, run ``train_cli.main`` on the card (the two
    stages, then the final eval sweep), check its gates.  Returns the final
    state, the argv, the model path, the record of the hooks and (per-view
    metrics by split, the sweep's compositor launches)."""
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.utils.ply import read_ply

    root = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    clip, out = os.path.join(root, "clip"), os.path.join(root, "out")
    t0 = time.time()
    scene = gt_scene(np.random.default_rng(CLIP_SEED), CLIP_DENSITY)
    overflow, n_lidar = write_clip(torch, dev, clip, scene,
                                   np.random.default_rng(CLIP_SEED + 1),
                                   CLIP_FRAMES, H, W, CLIP_LIDAR)
    check(overflow["overflow_visible"] == overflow["overflow_pairs"] == 0,
          f"ground-truth renders overflowed their budgets: {overflow}")
    print(f"clip: {CLIP_FRAMES} frames x {len(CAM_YAWS)} cameras {H}x{W}, "
          f"ground truth from {len(scene['pts'])} gaussians (density "
          f"{CLIP_DENSITY}; rects clamped to 6x6 tiles over the "
          f"{CLIP_FRAMES * len(CAM_YAWS)} renders: "
          f"{overflow['overflow_rect']}), {n_lidar} LiDAR points, written "
          f"in {time.time() - t0:.2f} s", flush=True)
    del scene

    argv = ["-s", clip, "--model_path", out, "--seed", str(CLIP_SEED),
            "--coarse_iterations", str(CLI_COARSE),
            "--iterations", str(CLI_FINE),
            "--densify_from_iter", str(CLI_DENSIFY_FROM),
            "--densification_interval", str(CLI_DENSIFY_EVERY),
            "--opacity_reset_interval", str(CLI_RESET),
            "--checkpoint_iterations", str(CLI_CKPT),
            "--pair_budget", "4194304"]            # bench.py's budget
    print(f"cli: train_cli.main({' '.join(argv[4:])}) with "
          f"S3G_LOG_EVERY={CLI_LOG_EVERY} and S3G_LPIPS_WEIGHTS={LPIPS_FIXTURE} "
          f"(the committed fixture weights: LPIPS's graph, not its "
          f"calibration); cut from the defaults: depth (coarse 5000 -> "
          f"{CLI_COARSE}, fine 50000 -> {CLI_FINE}) and cadence (densify "
          f"from 500 every 100 -> from {CLI_DENSIFY_FROM} every "
          f"{CLI_DENSIFY_EVERY}, opacity reset every 3000 -> {CLI_RESET}, "
          f"checkpoints at 30000 and 50000 -> {CLI_CKPT}), the pair budget "
          f"at bench.py's 2^22; the final eval sweep runs", flush=True)
    rec = new_record()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.time()
    with cli_hooks(torch, rec):
        tk.launches = tk.bwd_launches = 0
        state = train_cli.main(argv)
        torch.cuda.synchronize()
    run_s = time.time() - t0
    check(len(rec["evals"]) == 1, f"{len(rec['evals'])} eval sweeps, not 1")
    launches = rec["train_launches"]
    peak_gib = rec["train_peak"] / 2 ** 30

    # gates
    sc = rec["scene"]
    n_init = len(sc.info.points)
    print(f"cli: reader {rec['reader_s']:.2f} s ({card}); init cloud "
          f"{n_init} points after the voxel dedup and aabb clip, pool "
          f"capacity {sc.pool.capacity}, {len(sc.get_train_cameras())} train "
          f"cameras, extent {sc.cameras_extent:.2f}", flush=True)
    check(INIT_CLOUD_RANGE[0] <= n_init <= INIT_CLOUD_RANGE[1]
          and sc.pool.capacity == CLI_CAPACITY,
          f"init cloud {n_init} (capacity {sc.pool.capacity}): outside "
          f"{INIT_CLOUD_RANGE} / {CLI_CAPACITY}")
    del sc, rec["scene"]
    log = read_logger(os.path.join(out, "logger.json"))
    steps = [l for l in log if "Loss" in l]
    for l in steps:
        where = f"{l['stage']} step {l['step']}"
        check(math.isfinite(l["Loss"]), f"{where}: Loss {l['Loss']}")
        # ovf_rect counts the visible Gaussians whose tile rect the 4x4
        # cap clamps (near-field splats of the LiDAR init); it is printed,
        # not gated: no budget of the default configuration covers them
        check(l["ovf_vis"] == l["ovf_pairs"] == 0,
              f"{where}: overflow visible {l['ovf_vis']} pairs "
              f"{l['ovf_pairs']}")
        check(l["nan_skips"] == 0, f"{where}: nan_skips {l['nan_skips']}")
    want_steps = ([("coarse", 1)] + [("coarse", i) for i in range(
        CLI_LOG_EVERY, CLI_COARSE + 1, CLI_LOG_EVERY)] + [("fine", 1)]
        + [("fine", i) for i in range(CLI_LOG_EVERY, CLI_FINE + 1,
                                      CLI_LOG_EVERY)])
    check([(l["stage"], l["step"]) for l in steps] == want_steps,
          f"logged steps {[(l['stage'], l['step']) for l in steps]}")
    dens = [l for l in log if "densify" in l]
    check(any(d["densify"]["n_cloned"] + d["densify"]["n_split"] > 0
              for d in dens), "no densify cloned or split")
    check(any(d["densify"]["n_pruned"] > 0 for d in dens), "nothing pruned")
    check(all(d["densify"]["overflow"] == 0 for d in dens),
          "a densify ran out of free slots")
    resets = [(l["stage"], l["step"]) for l in log if "opacity_reset" in l]
    check(resets == [(stage, i) for stage, n in (("coarse", CLI_COARSE),
                                                 ("fine", CLI_FINE))
                     for i in range(CLI_RESET, n + 1, CLI_RESET)],
          f"opacity resets at {resets}")
    # the fit must improve over the coarse stage, which no screen prune
    # reaches (it needs a densify past the opacity-reset interval); the
    # fine stage's 20-px screen prune of the reference's density control
    # takes whatever still covers many pixels, so the fine psnr is printed
    coarse_psnr = [l["psnr"] for l in steps if l["stage"] == "coarse"]
    psnr0, psnr1 = coarse_psnr[0], coarse_psnr[-1]
    check(psnr1 > psnr0, f"psnr at coarse {CLI_COARSE} {psnr1} not above "
          f"coarse step 1 {psnr0}")
    check(launches == (CLI_COARSE + CLI_FINE,) * 2,
          f"{launches} forward/backward launches for "
          f"{CLI_COARSE + CLI_FINE} train steps")
    # the last Loss line logs before its step's densify; the pool the
    # checkpoint and PLY hold is the one after it
    flat = torch.load(os.path.join(out, f"chkpnt_fine_{CLI_FINE}",
                                   ckpt.STATE_FILE), weights_only=True)
    n_ckpt = int(flat["pool.alive"].sum())
    n_ply = len(read_ply(os.path.join(out, "point_cloud",
                                      f"iteration_{CLI_FINE}",
                                      "point_cloud.ply"))["x"])
    last_dens = [d for d in dens if d["stage"] == "fine"]
    check(n_ckpt == n_ply == last_dens[-1]["densify"]["n_alive"]
          == int(state.pool.n_alive),
          f"alive: checkpoint {n_ckpt}, PLY {n_ply}, last densify "
          f"{last_dens[-1]['densify']['n_alive']}")
    check(steps[-1]["point"] == last_dens[-2]["densify"]["n_alive"],
          f"last logged point {steps[-1]['point']} vs the densify before it "
          f"{last_dens[-2]['densify']['n_alive']}")
    check(sorted(d for d in os.listdir(out) if d.startswith("chkpnt_"))
          == [f"chkpnt_fine_{CLI_FINE}"], "older checkpoints left")
    with open(os.path.join(out, "cameras.json")) as f:
        n_cams = len(json.load(f))
    check(n_cams == CLIP_FRAMES * len(CAM_YAWS), f"cameras.json: {n_cams}")
    fine_alloc = [a for s, a in rec["alloc"] if s == "fine"]
    half = len(fine_alloc) // 2
    check(max(fine_alloc[half:]) <= (1 + ALLOC_GROWTH) * max(fine_alloc[:half]),
          f"device memory after a fine step grew from "
          f"{max(fine_alloc[:half])} to {max(fine_alloc[half:])} bytes")

    print("cli: densify " + "; ".join(
        f"{d['stage']} {d['step']}: +{d['densify']['n_cloned']} cloned "
        f"+{d['densify']['n_split']} split -{d['densify']['n_pruned']} "
        f"pruned (opacity {d['densify']['n_prune_opacity']}, screen "
        f"{d['densify']['n_prune_screen']}, world "
        f"{d['densify']['n_prune_world']}) -> {d['densify']['n_alive']}"
        for d in dens), flush=True)
    print("cli: logged step:Loss/psnr/point/ovf_rect " + " ".join(
        f"{l['stage'][0]}{l['step']}:{l['Loss']:.4f}/{l['psnr']:.2f}"
        f"/{l['point']}/{l['ovf_rect']}" for l in steps), flush=True)
    rates = {s: [l for l in steps if l["stage"] == s][-1]["it_per_s"]
             for s in ("coarse", "fine")}
    print(f"cli: {CLI_COARSE} coarse + {CLI_FINE} fine steps and the final "
          f"sweep in {run_s:.2f} s; "
          f"it/s coarse {rates['coarse']} fine {rates['fine']}; coarse psnr "
          f"{psnr0} -> {psnr1} dB, fine {steps[-1]['psnr']} dB at step "
          f"{CLI_FINE}; {launches[0]} forward / {launches[1]} "
          f"backward launches; alive {n_ckpt} in the checkpoint and the PLY "
          f"({card})", flush=True)
    print(f"cli: densify_step ms at capacity {CLI_CAPACITY} (CUDA events): "
          + " ".join(f"{x:.2f}" for x in rec["densify_ms"])
          + f" | median {np.median(rec['densify_ms']):.2f}; checkpoint save "
          f"ms (host clock): " + " ".join(f"{x:.1f}" for x in rec["save_ms"])
          + f"; device memory after a fine step {min(fine_alloc) / 2**30:.2f}"
          f"-{max(fine_alloc) / 2**30:.2f} GiB; peak {peak_gib:.2f} GiB, "
          f"{held_gib:.2f} GiB of it held before the run ({card})",
          flush=True)
    sweep = check_sweep(torch, rec, out, int(state.step), card, "cli")
    return state, argv, out, rec, sweep


def compare_step(torch, start, s_gpu, s_cpu, aux_g, aux_c, what):
    """One train step's result on the card against the CPU's from the same
    state: the loss rtol STEP_LOSS_RTOL; each tensor's update atol
    STEP_ATOL_SCALE·max|update| rtol STEP_RTOL; denom and max_radii2d
    equal but for 0.1% of the rows; xyz_grad_accum atol
    STEP_ATOL_SCALE·max.  Returns (GPU loss, CPU loss, worst update error
    over its tensor's largest update, xyz_grad_accum max abs error)."""
    lg, lc = aux_g["metrics"]["loss"].item(), aux_c["metrics"]["loss"].item()
    check(abs(lg - lc) <= STEP_LOSS_RTOL * abs(lc),
          f"{what} loss GPU {lg} vs CPU {lc}")
    got, want = snapshot(torch, s_gpu), snapshot(torch, s_cpu)
    worst_step = 0.0
    for key, w0 in start.items():
        dg = (got[key].cpu() - w0).double()
        dc = (want[key] - w0).double()
        scale = max(float(dc.abs().max()), 1e-30)
        err = (dg - dc).abs()
        bad = err > STEP_ATOL_SCALE * scale + STEP_RTOL * dc.abs()
        check(not bool(bad.any()),
              f"{what} {key}: update differs at {int(bad.sum())} "
              f"of {bad.numel()} entries, max {float(err.max()):.3e} vs "
              f"scale {scale:.3e}")
        worst_step = max(worst_step, float(err.max()) / scale)
    for f in ("denom", "max_radii2d"):
        a, b = getattr(s_gpu.stats, f).cpu(), getattr(s_cpu.stats, f)
        n_diff = int((a != b).sum())
        check(n_diff <= max(1, a.numel() // 1000),
              f"{what} {f}: {n_diff} rows differ")
    acc_g, acc_c = s_gpu.stats.xyz_grad_accum.cpu(), s_cpu.stats.xyz_grad_accum
    acc_err = float((acc_g - acc_c).abs().max())
    check(acc_err <= STEP_ATOL_SCALE * float(acc_c.abs().max()),
          f"{what} xyz_grad_accum differs by {acc_err:.3e}")
    return lg, lc, worst_step, acc_err


def mid_training(torch, state, seed):
    """``state`` with random mid-training Adam moments (count 5), in
    place."""
    mrng = np.random.default_rng(seed)
    for tree_, sc in ((state.adam.mu, 1e-3), (state.adam.nu, 1e-6)):
        for d in tree_.values():
            for v in d.values():
                x = mrng.normal(size=tuple(v.shape)) * sc
                v.copy_(torch.from_numpy(np.abs(x) if sc < 1e-4 else x))
    state.adam.count.fill_(5)
    return state


def small_rig_step(torch, dev, hp, opt, pipe, bg, card):
    """Phase 6b: one rig step (3 cameras yawed -40/0/+40 at one time,
    96x160) on a small street360 cloud with the union cull (a budget below
    the pool) and two-class emission, on the card and on the CPU (plain
    compositors) from one mid-training state, held to phase 6's
    train-step tolerances; the expanded visibility and vis_count equal but
    for 0.1% of the rows."""
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import trainer as tr

    pts, cols, rng = street360(4000, seed=5)
    pts[:, [0, 2]] *= 0.25                 # radius 0.5-15: near bigs
    cfg = RasterConfig(max_visible=3072, pair_budget=1 << 18, big_budget=256,
                       cull_before_deform=True)
    s_cpu = mid_training(torch, tr.init_state(
        create_from_pcd(pts, cols, 4096, device="cpu"),
        DeformationField(hp, torch.Generator().manual_seed(1), "cpu"),
        torch.tensor([[20.0, 20.0, 20.0], [-20.0, -20.0, -5.0]])), 4)
    s_gpu = state_to(torch, s_cpu, dev)
    start = snapshot(torch, s_cpu)
    imgs = rng.random((3, 96, 160, 3)).astype(np.float32)
    dmaps = rng.uniform(1, 15, (3, 96, 160)).astype(np.float32)
    res = []
    for d, st, b in ((dev, s_gpu, bg), ("cpu", s_cpu, bg.cpu())):
        cams = [rig_camera(torch, d, yaw, 0.5, 96, 160, imgs[i], dmaps[i])
                for i, yaw in enumerate(YAWS_DEG)]
        l0 = (tk.launches, tk.bwd_launches)
        res.append(tr.train_step_multicam(st, cams, "fine", 3, hp, opt, pipe,
                                          cfg, SPATIAL_LR_SCALE, b))
        got = (tk.launches - l0[0], tk.bwd_launches - l0[1])
        want = (0, 0) if str(d) == "cpu" else (3, 3)
        check(got == want, f"small rig step on {d}: {got} launches")
    (s_gpu, aux_g), (s_cpu, aux_c) = res
    lg, lc, worst, acc_err = compare_step(torch, start, s_gpu, s_cpu, aux_g,
                                          aux_c, "small rig step")
    for k in ("visible", "vis_count"):
        n_diff = int((aux_g[k].cpu() != aux_c[k]).sum())
        check(n_diff <= max(1, aux_c[k].numel() // 1000),
              f"small rig step {k}: {n_diff} rows differ")
    n_vis = int(aux_c["visible"].sum())
    check(0 < n_vis < int(s_cpu.pool.alive.sum()),
          f"small rig step: {n_vis} visible rows, the cull left none out")
    print(f"reference: small rig step (cull, max_visible 3072 of 4000, "
          f"big_budget 256) GPU vs CPU: loss {lg:.6f} vs {lc:.6f}, worst "
          f"update error {worst:.3e} of its tensor's largest update, "
          f"xyz_grad_accum max abs err {acc_err:.3e}; {n_vis} visible, "
          f"rect-clamped {int(aux_c['overflow_rect'])} (demoted bigs "
          f"included), n_pairs {int(aux_c['n_pairs'])}", flush=True)


def timed_rig_steps(torch, state, rigs, su, cfg, n_warmup, what):
    """Rig steps of ``train_step_multicam`` over ``rigs`` (lists of
    same-time cameras) with its gates: a finite loss, no pair or visible
    overflow, one forward and one backward launch a camera.  Returns the
    state, the last aux and the CUDA-event ms of the steps after the
    first ``n_warmup``."""
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import trainer as tr

    ms = []
    for i, cams in enumerate(rigs):
        l0 = (tk.launches, tk.bwd_launches)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, aux = tr.train_step_multicam(state, cams, "fine", 3, su.hp,
                                            su.opt, su.pipe, cfg,
                                            SPATIAL_LR_SCALE, su.bg)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= n_warmup:
            ms.append(ev[0].elapsed_time(ev[1]))
        loss = aux["metrics"]["loss"].item()
        check(math.isfinite(loss), f"{what} step {i}: loss {loss}")
        for k in ("overflow_pairs", "overflow_visible"):
            check(int(aux[k]) == 0, f"{what} step {i}: {k} {int(aux[k])}")
        got = (tk.launches - l0[0], tk.bwd_launches - l0[1])
        check(got == (len(cams),) * 2, f"{what} step {i}: {got} forward/"
              f"backward launches for {len(cams)} cameras")
    check(int(state.nan_skips) == 0, f"{what}: nan_skips "
          f"{int(state.nan_skips)}")
    return state, aux, ms


def rig_split(torch, state, rigs, su, cfg):
    """Median forward / backward / optimizer ms of rig steps (CUDA
    events)."""
    from s3gaussian_tpu_torch.train import trainer as tr

    parts = {"forward": [], "backward": [], "optimizer": []}
    for cams in rigs:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, aux, tree, tap = tr.step_forward(state, cams, "fine", 3, su.hp,
                                               su.opt, su.pipe, cfg, su.bg)
        ev[1].record()
        grads, tap_grad = tr.step_gradients(loss, tree, tap)
        ev[2].record()
        state = tr.rig_update(state, grads, tap_grad, loss.detach(), aux,
                              len(cams), su.opt, SPATIAL_LR_SCALE)
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
        del loss, aux, tree, tap, grads, tap_grad
    return state, {k: float(np.median(v)) for k, v in parts.items()}


def rig_step_phase(torch, su, state, card, single_ms):
    """Phase 5b: bench.py's detail_multicam3 workload, the headline scene
    trained a rig of 3 cameras (yaw -40/0/+40 degrees, one time) a step
    from phase 5's state.  Returns the state and the compositor launches
    of its timed steps."""
    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    dev = su.bg.device
    rigs = [[rig_camera(torch, dev, yaw, 0.4 + 1e-4 * i, H, W, su.gt,
                        su.gt_depth) for yaw in YAWS_DEG]
            for i in range(RIG_WARMUP + RIG_STEPS + SPLIT_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l0 = (tk.launches, tk.bwd_launches)
    state, aux, ms = timed_rig_steps(torch, state,
                                     rigs[:RIG_WARMUP + RIG_STEPS], su,
                                     su.cfg, RIG_WARMUP, "rig step")
    launches = (tk.launches - l0[0], tk.bwd_launches - l0[1])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    state, split = rig_split(torch, state, rigs[RIG_WARMUP + RIG_STEPS:], su,
                             su.cfg)
    med = float(np.median(ms))
    print(f"rig step (bench.py's detail_multicam3: {N_GAUSSIANS} in "
          f"{CAPACITY}, 3 cameras yawed {YAWS_DEG} at one time, pair budget "
          f"2^22, big_budget 0): ms (CUDA events, {RIG_STEPS} after "
          f"{RIG_WARMUP} warm-up) " + " ".join(f"{x:.2f}" for x in ms)
          + f" | median {med:.2f}; {3e3 / med:.3f} cameras/s against "
          f"{1e3 / single_ms:.3f} for the single-camera step (median "
          f"{single_ms:.2f} ms); split (median of {SPLIT_STEPS}) "
          + " ".join(f"{k}={v:.3f}" for k, v in split.items())
          + f" ms; n_pairs {int(aux['n_pairs'])} over the rig, visible "
          f"{int(aux['visible'].sum())}, rect-clamped "
          f"{int(aux['overflow_rect'])}; peak device memory {peak_gib:.2f} "
          f"GiB; {launches[0]} forward / {launches[1]} backward launches "
          f"({card})", flush=True)
    return state, launches


def street360(n, seed=0):
    """bench.py's street360 cloud: ``n`` LiDAR-like points around the ego
    (radius 2-60, height -1.5-6 in the camera frame), their colours, and
    the generator as bench.py leaves it before drawing its targets."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(2.0, 60.0, n)
    y = rng.uniform(-1.5, 6.0, n)
    pts = np.stack([rad * np.sin(ang), y, rad * np.cos(ang)],
                   1).astype(np.float32)
    return pts, rng.random((n, 3)).astype(np.float32), rng


def waymo_rig_phase(torch, dev, card):
    """Phase 6c: bench.py's detail_waymo_rig at full width: the street360
    cloud of 1.5 M points in a 1,507,328 pool, the default field, the
    3-camera forward rig yawed 40 degrees apart, the union cull with
    max_visible 589,824, two-class emission with big_budget 131,072, pair
    budget 2^23; a few rig steps.  Returns the compositor launches of its
    steps."""
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.render.renderer import cull_working_set
    from s3gaussian_tpu_torch.train import trainer as tr

    t0 = time.time()
    pts, cols, rng = street360(WAYMO_N)
    pool = create_from_pcd(pts, cols, WAYMO_CAP, device=dev)
    gt = rng.random((H, W, 3)).astype(np.float32)
    gt_depth = rng.uniform(1, 70, (H, W)).astype(np.float32)
    hp = ModelHiddenParams()
    su = types.SimpleNamespace(
        hp=hp, opt=OptimizationParams(), pipe=PipelineParams(),
        bg=torch.zeros(3, device=dev))
    cfg = RasterConfig(tile_x=16, tile_y=16, max_visible=WAYMO_MAX_VISIBLE,
                       rect_w=4, rect_h=4, pair_budget=WAYMO_PAIR_BUDGET,
                       chunk=128, big_budget=WAYMO_BIG_BUDGET,
                       cull_before_deform=True)
    state = tr.init_state(
        pool, DeformationField(hp, torch.Generator().manual_seed(0), dev),
        torch.tensor([[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]],
                     device=dev))
    rigs = [[rig_camera(torch, dev, yaw, 0.4 + 1e-4 * i, H, W, gt, gt_depth)
             for yaw in YAWS_DEG]
            for i in range(WAYMO_WARMUP + WAYMO_STEPS + SPLIT_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    with torch.no_grad():
        work, vis0, _ = cull_working_set(state.pool, rigs[0], cfg)
        n_union = int(vis0.sum())
        n_work = int(work.alive.sum())
    del work, vis0
    torch.cuda.reset_peak_memory_stats()
    l0 = (tk.launches, tk.bwd_launches)
    n_timed = WAYMO_WARMUP + WAYMO_STEPS
    try:
        state, aux, ms = timed_rig_steps(torch, state, rigs[:n_timed], su,
                                         cfg, WAYMO_WARMUP, "waymo rig")
        launches = (tk.launches - l0[0], tk.bwd_launches - l0[1])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        state, split = rig_split(torch, state, rigs[n_timed:], su, cfg)
    except torch.cuda.OutOfMemoryError as e:
        raise SmokeFailure(f"waymo rig: the card ran out of memory "
                           f"(remat_deform is not ported): {e}") from e
    med = float(np.median(ms))
    print(f"waymo rig (bench.py's detail_waymo_rig: street360 {WAYMO_N} in "
          f"{WAYMO_CAP}, 3 cameras yawed {YAWS_DEG}, cull, max_visible "
          f"{WAYMO_MAX_VISIBLE}, big_budget {WAYMO_BIG_BUDGET}, pair budget "
          f"2^23): set-up {setup_s:.2f} s; ms per rig step (CUDA events, "
          f"{WAYMO_STEPS} after {WAYMO_WARMUP} warm-up) "
          + " ".join(f"{x:.2f}" for x in ms)
          + f" | median {med:.2f}, {3e3 / med:.3f} cameras/s; split "
          f"(median of {SPLIT_STEPS}) "
          + " ".join(f"{k}={v:.3f}" for k, v in split.items())
          + f" ms; union cull "
          f"{n_union} rows of {int(pool.alive.sum())}, working set {n_work} "
          f"of {WAYMO_MAX_VISIBLE} ({max(n_union - WAYMO_MAX_VISIBLE, 0)} "
          f"rows of the union beyond the budget, not rendered); n_pairs {int(aux['n_pairs'])} over the "
          f"rig; overflow pairs {int(aux['overflow_pairs'])} visible "
          f"{int(aux['overflow_visible'])} rect {int(aux['overflow_rect'])} "
          f"(most in a camera, demoted bigs included); peak device memory "
          f"{peak_gib:.2f} GiB; {launches[0]} forward / {launches[1]} "
          f"backward launches ({card})", flush=True)
    check(n_work == min(n_union, WAYMO_MAX_VISIBLE), f"waymo rig: union "
          f"{n_union} rows, working set {n_work} of {WAYMO_MAX_VISIBLE}")
    return launches


def perf_cli_phase(torch, argv7, card):
    """Phase 9: ``train_cli.main`` with ``--configs arguments/waymo_perf.py``
    (a rig of 3 same-time cameras a step, the pre-deformation cull, the
    auto-sized max_visible) on phase 7's clip, phase 7's cadence and
    fewer steps, then its final eval sweep; the gates of phase 7 with 3
    forward and 3 backward launches a rig step, and check_sweep's.
    Returns the compositor launches of its training and of its sweep."""
    from s3gaussian_tpu_torch import train_cli

    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    out = os.path.join(os.path.dirname(argv7[3]), "out_waymo_perf")
    argv = (argv7[:2] + ["--model_path", out] + argv7[4:]
            + ["--coarse_iterations", str(PERF_COARSE),
               "--iterations", str(PERF_FINE),
               "--configs", os.path.join(REPO, "arguments", "waymo_perf.py")])
    print(f"waymo_perf: train_cli.main({' '.join(argv[4:])}): phase 7's "
          f"clip and cadence, {PERF_COARSE} coarse + {PERF_FINE} fine rig "
          f"steps of 3 cameras; the final eval sweep runs", flush=True)
    rec = new_record()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with cli_hooks(torch, rec), contextlib.redirect_stdout(buf):
            tk.launches = tk.bwd_launches = 0
            state = train_cli.main(argv)
            torch.cuda.synchronize()
    finally:
        printed = buf.getvalue()
        print(printed, end="", flush=True)
    run_s = time.time() - t0
    check(len(rec["evals"]) == 1, f"waymo_perf: {len(rec['evals'])} sweeps")
    sized = re.findall(r"^auto-sized max_visible = (\d+)$", printed, re.M)
    check(len(sized) == 1 and 0 < int(sized[0]) <= CLI_CAPACITY,
          f"waymo_perf: auto-sized max_visible lines {sized}")
    log = read_logger(os.path.join(out, "logger.json"))
    steps = [l for l in log if "Loss" in l]
    for l in steps:
        where = f"waymo_perf {l['stage']} step {l['step']}"
        check(math.isfinite(l["Loss"]), f"{where}: Loss {l['Loss']}")
        check(l["ovf_vis"] == l["ovf_pairs"] == 0,
              f"{where}: overflow visible {l['ovf_vis']} pairs "
              f"{l['ovf_pairs']}")
        check(l["nan_skips"] == 0, f"{where}: nan_skips {l['nan_skips']}")
    check([l["step"] for l in steps if l["stage"] == "fine"][-1] == PERF_FINE,
          "waymo_perf: the fine stage did not reach its end")
    dens = [l for l in log if "densify" in l]
    check(any(d["densify"]["n_cloned"] + d["densify"]["n_split"] > 0
              for d in dens), "waymo_perf: no densify cloned or split")
    check(any(d["densify"]["n_pruned"] > 0 for d in dens),
          "waymo_perf: nothing pruned")
    coarse_psnr = [l["psnr"] for l in steps if l["stage"] == "coarse"]
    check(coarse_psnr[-1] > coarse_psnr[0], f"waymo_perf: coarse psnr "
          f"{coarse_psnr[0]} -> {coarse_psnr[-1]}")
    n_steps = PERF_COARSE + PERF_FINE
    launches = rec["train_launches"]
    check(launches == (3 * n_steps,) * 2,
          f"waymo_perf: {launches} forward/backward launches for {n_steps} "
          f"rig steps of 3 cameras")
    rates = {s: [l for l in steps if l["stage"] == s][-1]["it_per_s"]
             for s in ("coarse", "fine")}
    print("waymo_perf: densify " + "; ".join(
        f"{d['stage']} {d['step']}: +{d['densify']['n_cloned']} cloned "
        f"+{d['densify']['n_split']} split -{d['densify']['n_pruned']} "
        f"pruned (screen {d['densify']['n_prune_screen']}) -> "
        f"{d['densify']['n_alive']}" for d in dens), flush=True)
    print("waymo_perf: logged step:Loss/psnr/point/ovf_rect " + " ".join(
        f"{l['stage'][0]}{l['step']}:{l['Loss']:.4f}/{l['psnr']:.2f}"
        f"/{l['point']}/{l['ovf_rect']}" for l in steps), flush=True)
    print(f"waymo_perf: auto-sized max_visible {sized[0]} (the largest "
          f"union of a frame's rig, x2); {PERF_COARSE} coarse + {PERF_FINE} "
          f"fine rig steps and the final sweep in {run_s:.2f} s; it/s "
          f"coarse {rates['coarse']} fine {rates['fine']}, cameras/s "
          f"coarse {3 * rates['coarse']:.3f} fine {3 * rates['fine']:.3f}; "
          f"coarse psnr {coarse_psnr[0]} -> {coarse_psnr[-1]} dB, fine "
          f"{steps[-1]['psnr']} dB; {launches[0]} forward / {launches[1]} "
          f"backward launches; training peak "
          f"{rec['train_peak'] / 2 ** 30:.2f} GiB ({card})", flush=True)
    _, sweep = check_sweep(torch, rec, out, int(state.step), card,
                           "waymo_perf")
    return launches, sweep


T_START = time.time()


def main() -> int:
    import torch

    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.eval.video import render_pixels
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.ops.composite import (composite_tiles_bwd_torch,
                                                    composite_tiles_torch)
    from s3gaussian_tpu_torch.render.renderer import render
    from s3gaussian_tpu_torch.train import trainer as tr

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"capability {cap}: the kernels are built for "
          f"sm_90a")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap}; host CPU "
          f"{torch.backends.cpu.get_cpu_capability()}", flush=True)
    dev = configure_device("cuda")

    # 2. build
    t0 = time.time()
    logs = tk.build()
    build_s = time.time() - t0
    for name, log in logs.items():
        print(f"build {name}: -> {tk.library_path(name).name} "
              f"[{' | '.join(ptxas_summary(log))}]")
    print(f"build: {build_s:.2f} s for {len(logs)} kernels in parallel",
          flush=True)

    # the headline workload of bench.py
    t0 = time.time()
    su = headline(torch, dev)
    pool, deform, aabb, pipe, cfg, bg, cams = (su.pool, su.deform, su.aabb,
                                               su.pipe, su.cfg, su.bg,
                                               su.cams)
    gt, gt_depth, hp, opt = su.gt, su.gt_depth, su.hp, su.opt
    torch.cuda.synchronize()
    print(f"scene: {N_GAUSSIANS} gaussians in a {CAPACITY} pool, "
          f"{len(cams)} cameras {H}x{W}, set-up {time.time() - t0:.2f} s",
          flush=True)

    # 3. kernels vs plain on the card, full-width view + high opacity
    gx, gy = -(-W // cfg.tile_x), -(-H // cfg.tile_y)
    n_tiles, p = gx * gy, cfg.tile_x * cfg.tile_y
    streams = kernel_streams(torch, su)
    gt_t = torch.tensor(gt, device=dev)
    gt_depth_t = torch.tensor(gt_depth, device=dev)
    geo = tk.launch_geometry(cfg.tile_x, cfg.tile_y)
    fwd = {"max_err": 0.0}
    bwd = {"max_err": 0.0}
    for name, (s, ts) in streams.items():
        n_pairs = int(ts[-1])
        got = tk.composite_fwd(s, ts, gx, gy, cfg.tile_x, cfg.tile_y)
        want = composite_tiles_torch(s, ts, gx, gy, cfg.tile_x, cfg.tile_y)
        torch.cuda.synchronize()
        err = compare_tiles(got, want)
        fwd["max_err"] = max(fwd["max_err"], err)
        ms = cuda_ms(torch, lambda: tk.composite_fwd(
            s, ts, gx, gy, cfg.tile_x, cfg.tile_y), reps=20)
        plain_ms = cuda_ms(torch, lambda: composite_tiles_torch(
            s, ts, gx, gy, cfg.tile_x, cfg.tile_y), reps=3, warmup=1)
        print(f"composite_fwd vs plain [{name}]: M={s.shape[1]} "
              f"n_pairs={n_pairs} tiles={n_tiles} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"[{geometry_str(geo, geo.fwd_smem_bytes)}] ({card})",
              flush=True)

        dout = step_loss_cotangent(torch, got, gt_t, gt_depth_t, opt, gx, gy,
                                   cfg)
        check(bool((dout[:, 5:] == 0).all()), "cotangent rows 5-7 not zero")
        gk = tk.composite_bwd(s, ts, got, dout, gx, gy, cfg.tile_x,
                              cfg.tile_y)
        gp = composite_tiles_bwd_torch(s, ts, got, dout, gx, gy, cfg.tile_x,
                                       cfg.tile_y)
        torch.cuda.synchronize()
        berr = compare_pair_grads(gk, gp, n_pairs)
        bwd["max_err"] = max(bwd["max_err"], berr)
        again = tk.composite_bwd(s, ts, got, dout, gx, gy, cfg.tile_x,
                                 cfg.tile_y)
        check(torch.equal(again, gk), "backward kernel not deterministic")
        bms = cuda_ms(torch, lambda: tk.composite_bwd(
            s, ts, got, dout, gx, gy, cfg.tile_x, cfg.tile_y), reps=10)
        bplain_ms = cuda_ms(torch, lambda: composite_tiles_bwd_torch(
            s, ts, got, dout, gx, gy, cfg.tile_x, cfg.tile_y), reps=1,
            warmup=1)
        print(f"composite_bwd vs plain [{name}]: max_abs_err={berr:.3e} "
              f"(scale {float(gp[:, :n_pairs].abs().max()):.3e}) kernel "
              f"{bms:.4f} ms plain {bplain_ms:.4f} ms "
              f"[{geometry_str(geo, geo.bwd_smem_bytes)}] ({card})",
              flush=True)

        evaluated, needed, group_pairs = work_counts(
            torch, s, ts, gx, gy, cfg.tile_x, cfg.tile_y,
            pixel_groups(torch, tk, geo, cfg.tile_x, cfg.tile_y, dev))
        contributing = int(got[:, 5].sum())
        wl, w1, col = (group_pairs[k] for k in ("launch", "one_per_thread",
                                                "column"))
        print(f"work [{name}]: {evaluated} pixel-pairs evaluated, "
              f"{contributing} contributing, {needed} pairs read of "
              f"{n_pairs}; warp-pairs with a lane evaluating (about the "
              f"backward's reductions, {REDUCE_SHUFFLES} shuffles each) / "
              f"with a contributor: {wl['evaluating']} / "
              f"{wl['contributing']} at {geo.pixels_per_thread} pixels "
              f"per thread, {w1['evaluating']} / {w1['contributing']} at "
              f"one; column-pairs {col['evaluating']} / "
              f"{col['contributing']}", flush=True)
        if name == "view":
            io_stream = needed * 10 * 4 + (n_tiles + 1) * 4
            alpha_ops = col["evaluating"] * COLUMN_OPS + evaluated * ALPHA_OPS
            fwd.update(ms=ms, plain_ms=plain_ms, work=(
                io_stream + n_tiles * 8 * p * 4,
                alpha_ops + contributing * FWD_BLEND_OPS))
            bwd.update(ms=bms, plain_ms=bplain_ms, work=(
                io_stream + 2 * n_tiles * 5 * p * 4 + 16 * s.shape[1] * 4,
                alpha_ops + contributing * BWD_BLEND_OPS
                + col["contributing"] * BWD_COLUMN_OPS))
        del gk, gp, again, dout
    for name, d in (("composite_fwd", fwd), ("composite_bwd", bwd)):
        d["bound"] = bound(*d["work"])
        print(f"bound {name} [view]: {d['work'][0]} bytes, {d['work'][1]} "
              f"f32 instructions -> {d['bound'][0]:.4f} ms, set by "
              f"{d['bound'][1]} (H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s "
              f"f32 = 33.5 T f32 instructions/s); kernel {d['ms']:.4f} ms = "
              f"{d['bound'][0] / d['ms']:.3f} of the bound", flush=True)
    del streams

    # 4. the render path through the user entry points, launches counted
    rasterize_calls = 0
    frame_ms = []
    renders = []
    tk.launches = tk.bwd_launches = 0
    with torch.no_grad():
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
    # the cameras carry no ground truth: frames only.  Two rigs of three
    # (render_multicam: full, dynamic and static per camera) and two flow
    # renders a camera
    frames = render_pixels(cams, pool, deform, pipe, bg, aabb, 3, "fine", cfg,
                           compute_metrics=False, return_decomposition=True)
    rasterize_calls += 5 * len(cams)
    torch.cuda.synchronize()
    render_launches = (tk.launches, tk.bwd_launches)
    check(render_launches == (rasterize_calls, 0),
          f"{render_launches} kernel launches for {rasterize_calls} "
          f"rasterize calls without gradient")
    for img, frame in zip(renders, frames["rgbs"]):
        want = (torch.round(torch.clamp(img, 0, 1).permute(1, 2, 0) * 255)
                / 255).cpu().numpy()
        step = np.abs(frame - want) * 255
        check(step.max() <= 1 + 1e-3 and (step > 0.5).mean() <= 1e-3,
              f"render_pixels frame differs from render(): max "
              f"{step.max():.3f}/255, {(step > 0.5).mean():.2e} of values")
    for k in ("dynamic_rgbs", "forward_flows", "backward_flows"):
        check(len(frames[k]) == len(cams), f"render_pixels: {k} missing")
    print(f"render path: {len(cams)} frames via render() + {len(cams)} via "
          f"render_pixels (2 rigs with the decomposition, 2 flow renders a "
          f"camera), {rasterize_calls} rasterize calls, {render_launches[0]} "
          f"forward / {render_launches[1]} backward launches", flush=True)
    print("frame ms (render(), host clock, synchronised): "
          + " ".join(f"{x:.2f}" for x in frame_ms)
          + f" | median {np.median(frame_ms):.2f} ({card})", flush=True)
    splits = [frame_stages(torch, cam, pool, deform, pipe, bg, aabb, cfg)[0]
              for cam in cams]
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    print("stage ms (median of the 6 frames, CUDA events): "
          + " ".join(f"{k}={v:.3f}" for k, v in split.items())
          + f" ({card})", flush=True)
    del renders, frames

    # 5. the training slice: 2 coarse + 5 fine train_steps, launches counted
    state = tr.init_state(pool, deform, aabb)
    before = snapshot(torch, state)
    train_cams = [rig_camera(torch, dev, 0.0, 0.4 + 1e-4 * i, H, W, gt,
                             gt_depth)
                  for i in range(COARSE_STEPS + FINE_STEPS + SPLIT_STEPS)]
    stages = ["coarse"] * COARSE_STEPS + ["fine"] * FINE_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    tk.launches = tk.bwd_launches = 0
    for cam, stage in zip(train_cams, stages):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, aux = tr.train_step(state, cam, stage, 3, hp, opt, pipe, cfg,
                                   SPATIAL_LR_SCALE, bg)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(aux["metrics"]["loss"].item())
        check(math.isfinite(losses[-1]), f"{stage} step: loss {losses[-1]}")
        check(int(aux["overflow_pairs"]) == 0,
              f"{stage} step: {int(aux['overflow_pairs'])} pairs beyond the "
              f"budget")
    train_launches = (tk.launches, tk.bwd_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = len(stages)
    check(train_launches == (n_steps, n_steps),
          f"{train_launches} forward/backward launches for {n_steps} "
          f"rasterize calls with gradient")
    check(int(state.nan_skips) == 0, f"nan_skips {int(state.nan_skips)}")
    check(int(state.step) == n_steps, f"step {int(state.step)}")
    after = snapshot(torch, state)
    moved = {}
    for (g, k), v in before.items():
        group = k if g == "pool" else ("grid" if k.startswith("grid.")
                                       else "deformation")
        moved[group] = moved.get(group, False) or not torch.equal(
            v, after[(g, k)])
    check(all(moved.values()), f"groups that did not move: "
          f"{[k for k, v in moved.items() if not v]}")
    vis = aux["visible"]
    check(int(vis.sum()) > 0 and bool((state.stats.denom[vis] > 0).all()),
          "denom is not > 0 on the visible rows")
    print(f"training slice: {COARSE_STEPS} coarse + {FINE_STEPS} fine "
          f"train_steps, losses " + " ".join(f"{x:.5f}" for x in losses)
          + f"; {train_launches[0]} forward / {train_launches[1]} backward "
          f"launches for {n_steps} rasterize calls; groups moved "
          f"{sorted(moved)}; n_pairs {int(aux['n_pairs'])}, "
          f"visible {int(vis.sum())}", flush=True)
    fine_ms = step_ms[COARSE_STEPS:]
    print("step ms (train_step, CUDA events): "
          + " ".join(f"{x:.2f}" for x in step_ms)
          + f" | fine median {np.median(fine_ms):.2f}; peak device memory "
          f"{peak_gib:.2f} GiB ({card})", flush=True)
    del before, after
    parts = {"forward": [], "backward": [], "optimizer": []}
    for cam in train_cams[n_steps:]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, aux, tree, tap = tr.step_forward(state, cam, "fine", 3, hp,
                                               opt, pipe, cfg, bg)
        ev[1].record()
        grads, tap_grad = tr.step_gradients(loss, tree, tap)
        ev[2].record()
        state = tr.apply_param_update(state, grads, tap_grad, loss.detach(),
                                      aux["radii"], aux["visible"], opt,
                                      SPATIAL_LR_SCALE)
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
        del loss, aux, tree, tap, grads, tap_grad
    print("fine step split (median of 3, CUDA events): "
          + " ".join(f"{k}={np.median(v):.3f}" for k, v in parts.items())
          + f" ms ({card})", flush=True)

    # 5b. the rig step at the headline, from phase 5's state
    state, rig_launches = rig_step_phase(torch, su, state, card,
                                         float(np.median(fine_ms)))
    del state

    # 6. small scene: GPU vs CPU (plain compositors): render + train step,
    # with the field made anew from its seed, then the renders with the
    # field phase 5 trained in place
    small_cfg = RasterConfig(max_visible=4096, pair_budget=1 << 16)
    small_pool, srng = make_scene(torch, dev, 3000, 4096, seed=2)
    cpu_pool = copy.copy(small_pool)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "alive"):
        setattr(cpu_pool, f, getattr(small_pool, f).cpu())
    deform = DeformationField(hp, torch.Generator().manual_seed(0), dev)
    cpu_deform = copy.deepcopy(deform).cpu()

    # The trained field's last bits follow the order of every gradient sum
    # of phase 5's 10 steps, and the two devices project its output with
    # last bits of their own, so a pair can fall on either side of a skip
    # or exit threshold on the two devices.  For the trained field a pixel
    # beyond tolerance must be shown to come from such a pair: its trace
    # on both devices' sorted streams, whose first differing decision
    # straddles a threshold.  The new field is held to every pixel within
    # tolerance; a pixel beyond it is traced and shown before the gate
    # fails.
    def gpu_vs_cpu(field_g, field_c, views, what, max_flipped):
        flipped, worst_rest = [], 0.0
        for yaw, t in views:
            cam_g = rig_camera(torch, dev, yaw, t, 96, 160)
            cam_c = rig_camera(torch, "cpu", yaw, t, 96, 160)
            with torch.no_grad():
                g = render(cam_g, small_pool, field_g, pipe, bg, aabb, 3,
                           cfg=small_cfg)
                c = render(cam_c, cpu_pool, field_c, pipe, bg.cpu(),
                           aabb.cpu(), 3, cfg=small_cfg)
            check(int(g["raster_aux"]["n_pairs"]) > 0, "small scene: no pairs")
            errs = [((g[k].cpu().double() - c[k].double()).abs(),
                     c[k].double().abs()) for k in ("render", "depth")]
            bad = torch.zeros(96, 160, dtype=torch.bool)
            pixel_err = torch.zeros(96, 160, dtype=torch.float64)
            for err, ref in errs:
                over = ~(err <= RGBD_ATOL + RGBD_RTOL * ref)   # NaN too
                bad |= over.any(0) if over.dim() == 3 else over
                pixel_err = torch.maximum(
                    pixel_err, err.amax(0) if err.dim() == 3 else err)
            worst_rest = max(worst_rest, float(pixel_err[~bad].max()))
            ys, xs = torch.nonzero(bad, as_tuple=True)
            if len(ys) == 0:
                continue
            sg = fine_stream(torch, cam_g, small_pool, field_g, bg, aabb,
                             small_cfg)
            sc = fine_stream(torch, cam_c, cpu_pool, field_c, bg.cpu(),
                             aabb.cpu(), small_cfg)
            traced = []
            for y, x in list(zip(ys.tolist(), xs.tolist()))[
                    :MAX_FLIPPED_PIXELS + 1]:
                tile = ((y // small_cfg.tile_y) * sg[2]
                        + x // small_cfg.tile_x)
                flips = threshold_flips(
                    torch, pixel_trace(torch, sg[0], sg[1], tile, x, y),
                    pixel_trace(torch, sc[0], sc[1], tile, x, y))
                traced.append((x, y, float(pixel_err[y, x]), flips))
            if len(ys) > max_flipped or not all(
                    f and f[0][0] != "unexplained" for *_, f in traced):
                for x, y, e, flips in traced:
                    print(f"  {what}: yaw {yaw} t {t} pixel ({x}, {y}) err "
                          f"{e:.3e}, first differing decisions (kind, "
                          f"depth, (GPU, CPU) values): {flips[:3]}",
                          flush=True)
            check(len(ys) <= max_flipped,
                  f"{what}, yaw {yaw} t {t}: {len(ys)} pixels beyond "
                  f"tolerance GPU vs CPU (max abs "
                  f"{float(pixel_err.max()):.3e}; at most {max_flipped})")
            for x, y, e, flips in traced:
                check(bool(flips) and flips[0][0] != "unexplained",
                      f"{what}, yaw {yaw} t {t}, pixel ({x}, {y}): GPU vs "
                      f"CPU differs by {e:.3e} with no pair on a threshold "
                      f"first: {flips[:3]}")
                flipped.append((yaw, t, x, y, e, flips[0]))
        print(f"reference: {what}, small scene (3000 gaussians, 96x160) "
              f"render GPU vs CPU (plain path) over {len(views)} views: "
              f"{len(flipped)} pixels beyond tolerance (at most "
              f"{max_flipped} a view, each behind a pair on a threshold); "
              f"max abs err elsewhere {worst_rest:.3e}", flush=True)
        for yaw, t, x, y, e, (kind, depth, vals) in flipped[:8]:
            print(f"  flip: yaw {yaw} t {t} pixel ({x}, {y}) err {e:.3e}: "
                  f"pair at depth {depth:.4f} on the {kind} threshold, "
                  f"(GPU, CPU) " + " ".join(
                      f"{k} ({v[0]:.9g}, {v[1]:.9g})"
                      for k, v in vals.items()), flush=True)

    gpu_vs_cpu(deform, cpu_deform, [(0.0, 0.5), (40.0, 0.5)], "new field", 0)
    gpu_vs_cpu(su.deform, copy.deepcopy(su.deform).cpu(),
               [(yaw, t) for yaw in YAWS_DEG for t in (0.3, 0.5, 0.7)],
               "trained field", MAX_FLIPPED_PIXELS)

    s_cpu = mid_training(torch, tr.init_state(cpu_pool, cpu_deform,
                                              aabb.cpu()), 3)
    s_gpu = state_to(torch, s_cpu, dev)
    start = snapshot(torch, s_cpu)
    img = srng.random((96, 160, 3)).astype(np.float32)
    dmap = srng.uniform(1, 70, (96, 160)).astype(np.float32)
    s_gpu, aux_g = tr.train_step(
        s_gpu, rig_camera(torch, dev, 0.0, 0.5, 96, 160, img, dmap), "fine",
        3, hp, opt, pipe, small_cfg, SPATIAL_LR_SCALE, bg)
    s_cpu, aux_c = tr.train_step(
        s_cpu, rig_camera(torch, "cpu", 0.0, 0.5, 96, 160, img, dmap),
        "fine", 3, hp, opt, pipe, small_cfg, SPATIAL_LR_SCALE, bg.cpu())
    lg, lc, worst_step, acc_err = compare_step(torch, start, s_gpu, s_cpu,
                                               aux_g, aux_c,
                                               "small train step")
    print(f"reference: small fine train_step GPU vs CPU: loss {lg:.6f} vs "
          f"{lc:.6f}, worst update error {worst_step:.3e} of its tensor's "
          f"largest update, xyz_grad_accum max abs err {acc_err:.3e}",
          flush=True)

    # 6b. a rig step with the union cull and two-class emission, GPU vs
    # CPU, from one mid-training state
    small_rig_step(torch, dev, hp, opt, pipe, bg, card)

    del su, pool, deform, cams, small_pool, cpu_pool, s_gpu, s_cpu
    torch.cuda.empty_cache()

    # 6c. the Waymo rig at full width: 1.5 M points, cull, two-class
    waymo_launches = waymo_rig_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # 7. the training CLI, this slice's main path; launches counted over it
    _, argv, out, rec7, (per_view7, sweep7) = cli_phase(torch, dev, card)
    metrics_on_card(torch, rec7, card)
    train7 = rec7["train_launches"]
    del rec7

    # 8. --eval_only on phase 7's model path
    sweep8, _ = eval_only_phase(torch, argv, out, per_view7, card)

    # 9. the waymo_perf preset through the CLI on phase 7's clip
    train9, sweep9 = perf_cli_phase(torch, argv, card)
    path = {"4 render path": render_launches, "5 training slice":
            train_launches, "5b rig step": rig_launches,
            "6c waymo rig": waymo_launches, "7 CLI training": train7,
            "7 final sweep": sweep7, "8 --eval_only sweep": sweep8,
            "9 waymo_perf training": train9, "9 waymo_perf sweep": sweep9}
    main_launches = tuple(sum(v[i] for v in path.values()) for i in (0, 1))
    print("compositor launches, forward / backward: " + "; ".join(
        f"{k} {v[0]} / {v[1]}" for k, v in path.items())
        + f"; total {main_launches[0]} / {main_launches[1]}", flush=True)
    check(rig_launches[0] > 0 and waymo_launches[0] > 0 and train9[0] > 0,
          "a rig phase launched no kernel")
    print(f"smoke run: {time.time() - T_START:.1f} s", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    kernels = []
    for name, d, line in (("composite_fwd", fwd, 211),
                          ("composite_bwd", bwd, 411)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"s3gaussian_tpu_torch/csrc/{name}.cu",
            "replaces": f"s3gaussian_tpu/ops/tile_kernels.py:{line}",
            "launches": main_launches[0 if name == "composite_fwd" else 1],
            "max_abs_err": d["max_err"],
            "ms": d["ms"],
            "plain_ms": d["plain_ms"],
            "bound_ms": d["bound"][0],
            "bound_by": d["bound"][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
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
