#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``s3gaussian_tpu_torch``) on one
NVIDIA Hopper GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, a few lines of output each (any failure exits non-zero before the
last line):

  1. the card (``nvidia-smi`` name and power limit), capability 9.0;
  2. build the five CUDA sources of ``s3gaussian_tpu_torch/csrc`` (the
     two compositors, the segment sum, the train step's span mark and the
     hexplane query's forward and backward; one ``nvcc`` each, in
     parallel), with ptxas registers and spills;
  3. each kernel vs its plain PyTorch version on the sorted pair stream of
     one full-width view and of a high-opacity variant (early exit), with
     the tolerances of ``tests/test_tile_kernels.py``, and both times
     beside the launch geometry (pixels per thread, threads, batch, shared
     bytes), the work counted on the stream, among it the warp-pairs with
     a contributor (the backward's reductions), and each kernel's bound
     for that work.  The backward's
     cotangent is the gradient of the train step's loss with respect to
     the compositor output;
  3b. the segment-sum kernel (``csrc/segment_sum.cu``: the field's grid
     gradients, in a fixed order) against its plain version on every call
     of one headline fine step, bit for bit on repeat; the largest call
     timed beside the plain version and ``index_add_``, with its bound;
  3c. the hexplane kernels (``csrc/hexplane.cu``: the field's query and
     its backward) against the plain version
     (``models/hexplane.py::query_hexplane_plain`` on the card) at the
     headline field and 2,097,152 rows (the pool of the benchmark's
     cells), bfloat16 planes moved off their init: the features and
     every plane's gradient bit for bit, the coordinate gradient within
     atol 1e-5·max|plain|, rtol 1e-4, a backward repeated bit for bit;
     the forward and the four backward launches timed beside their DRAM
     bound (the bytes their work requires) and a gather-traffic ceiling,
     and the query's forward and backward through both paths;
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
  7. the training CLI, the main path: a synthetic Waymo-layout clip
     written by ``tools/mini_clip.py::write_clip`` (10 frames x 3 cameras
     at 640x960, ground truth rendered from its known street scene of
     ~344k Gaussians with the port's rasterizer, 60,000 LiDAR points a
     frame, ``gt_motion.json``) under the ignored ``build/``, trained by
     ``train_cli.main`` with the default model and optimizer and only
     depth and cadence cut (60 coarse + 120 fine steps, density control
     every 20, opacity reset every 60; ``--steps_per_dispatch`` at its
     default 10, so blocks of 10 between the log and density events and
     every step a replay of the captured step, one capture a stage):
     every logged loss finite, no budget overflow, clones or splits and
     prunes, the opacity resets, the fit improving, one forward and one
     backward launch per step and per capture's warm-up step, the final
     checkpoint and PLY consistent; reader seconds, it/s per stage,
     ``densify_step`` ms, checkpoint save ms and peak memory.  Then the
     final eval sweep of the same call, with the committed LPIPS fixture
     weights (``S3G_LPIPS_WEIGHTS``), over the train and full splits (30
     cameras each, 10 rigs): a metrics JSON per split with the JAX
     package's keys, finite psnr/ssim, a float lpips, the masked metrics,
     one frame per camera of every frame key, the videos or PNGs written,
     no render beyond its budgets, 3 compositor launches per camera and 2
     per flow render; seconds per split, render rates, video writing
     seconds, peak memory; the sweep's renders are replays of a rig graph
     and a flow graph (one capture each a split).  Then (7b) the sweep's
     graphs against direct calls on the final model's train split: one
     eager render of each captured kind under
     ``torch.cuda.set_sync_debug_mode("error")``, then ``render_pixels``
     against ``render_multicam`` (with the decomposition) and ``render``
     (the flow colours of the direct dx): frames within 5e-4 of the
     clipped render beyond the uint8 step, flow frames included, depth
     atol 5e-4 rtol 1e-4, every per-view metric within 1e-5; replays a
     second, the captures' ms, and one rig render eager and replayed (ms,
     device operations, host launch calls).  Then SSIM, masked SSIM and
     LPIPS of one sweep frame on the card with TF32 switched on globally
     against the CPU in float64 (LPIPS float32), atol 1e-5, and each
     metric's ms per view;
  8. ``--eval_only`` on phase 7's model path: it restores the final fine
     checkpoint, its sweep holds phase 7's gates and reproduces its
     per-view metrics within 1e-6; on a fresh model path it refuses
     ("no checkpoint");
  9. the ``arguments/waymo_perf.py`` preset through ``train_cli.main``
     on phase 7's clip with its cadence (40 coarse + 80 fine rig steps
     of 3 cameras, the cull, the auto-sized ``max_visible``) and its
     final eval sweep: phase 7's gates (blocks of 10 rig steps) with 3
     forward and 3 backward launches a rig step, the printed budget and
     ``check_sweep``'s gates; it/s and cameras/s per stage;
 10. the offline tools on phase 7's model path: ``tools/eval_per_view``
     (its mean PSNR equals the final sweep's train-split mean within
     1e-4; one forward launch a camera and two flow renders),
     ``tools/eval_flow_epe`` (finite EPE at every probe frame and offset)
     and ``tools/metrics.py`` on a ``test/<method>/{renders,gt}``
     directory written from the sweep's train-split frames (finite PSNR
     and SSIM, one entry a view, LPIPS null without VGG weights);
 11. ``python -m s3gaussian_tpu_torch.bench`` in a subprocess at its
     defaults (bench.py's four workloads, each a warm-up block of 10
     steps and 2 timed blocks, replays of the captured step): the
     headline first and last, four detail lines without an
     error, no dropped pair, finite losses, one forward and one backward
     launch a camera of a step; its lines printed;
 12. data parallelism (``parallel/``), on the one card: (12a) NCCL at
     world size 1 in this process, at the headline: one fine
     ``parallel_train_step`` against ``train_step`` from one mid-training
     state (phase 6's train-step tolerances), and the reduction's extra
     ms (flattening and the all-reduce of its two buckets, CUDA events)
     with each bucket's bytes; (12b) two rank processes sharing the card
     over gloo (CUDA tensors staged through the host), at the headline:
     cameras yawed -40/+40, 2 coarse + 3 fine ``parallel_train_step``s
     and 3 ``parallel_train_step_multicam``s on a rig of 3 a rank, the
     replicas' checksums equal after every step, rank 0's state after the
     first fine step against a single-process emulation of the two
     cameras' averaged step (phase 6's tolerances); ms a step and of the
     all-reduce, bytes; (12c) the CLI with ``--batch_size 2`` on two gloo
     ranks on phase 7's clip (20 coarse + 40 fine, density control from
     10 every 20, no sweep, ``--steps_per_dispatch 1``: gloo's
     all-reduces cannot be captured): finite losses, one logger line a
     logged step
     (rank 0 alone writes), no overflow, the densifies, one checkpoint
     and one PLY, the replicas equal at the end; it/s per stage.  The
     two-rank figures are labelled: two ranks sharing one card are not a
     scaling figure;
 13. the train step as a captured CUDA graph (``train/graphs.py``)
     against the eager step, run after 5b from its pool, field and Adam
     moments, cameras that
     differ in yaw, time, field of view and target: (a) a fine block of
     10 through ``train_steps_scan``, (b) 3 rigs of 3 through
     ``train_steps_scan_multicam``, (c) a ``densify_step`` between two
     blocks of 3, the second loaded into the held graph without a
     recapture, (d) a block of 5 ``parallel_train_steps_scan`` under
     NCCL at world size 1 against ``train_steps_scan``; each held to
     phase 6's step tolerances step by step (metrics and counters), then
     the parameters, moments and statistics; one forward and one
     backward launch a camera captured and counted a replay; the second
     eager step of each kind runs under
     ``torch.cuda.set_sync_debug_mode("error")``.  Per block: the
     warm-up and capture ms, ms a step replayed and eager (CUDA events,
     median), device operations, host launch calls and device ms a step
     as ``torch.profiler`` counts them, peak and reserved memory.  The
     span marks of (a) and (b) (``utils/spans.py``): one ``span_mark``
     launch a mark of the step's sequence (the field's two inner spans
     included) captured and counted a replay
     and a warm-up step, as many ``span_mark`` kernels a replayed step in
     the profile, the replayed steps' spans within 5% of their
     CUDA-event time; the marks' device ms a step printed.  The hexplane
     kernels of (a) and (b): one ``hexplane_fwd`` and a ``hexplane_bwd``
     a scale (1 + 4) a step's field evaluation captured, and counted a
     replay and a warm-up step.  (e) Two
     eager steps from one state give the same bits (loss, parameters,
     moments, statistics): the headline camera and 5b's rig with
     two-class emission here, the Waymo rig with its cull in 6c; a step's
     profile holds no ``indexing_backward_kernel`` or
     ``indexFuncLargeIndex``, the backward's largest kernels are printed,
     and one step runs under ``torch.use_deterministic_algorithms(True,
     warn_only=True)`` as a diagnostic (what PyTorch flags is printed).
     ``python3 chip_smoke.py --phase 13`` runs the build and this phase
     alone, on a fresh headline state with mid-training moments, and
     prints no result line;
 14. the reference's scene matrix (run after 10): a 21-frame clip of
     phase 7's street (``write_clip``, 640x960, phase 7's density) and
     the default model, phase 9's cadence (40 coarse + 80 fine steps):
     (a) ``arguments/nvs.py`` on frames 0-10 through ``train_cli.main``
     in this process (phase 7's gates, frame 10's cameras held out, the
     sweep's test, train and full splits), (b) ``static_nvs.py``
     likewise (no position head: no decomposition or flow renders, no
     ``heads.pos``, no split PLY), (c) ``stage2.py`` merged (frames
     11-20) from (a)'s checkpoint (the field the prior's bit for bit
     after the transplant; frame 11 at time 11/20), (d) ``stage2_nvs.py``
     merged through ``python -m s3gaussian_tpu_torch.tools.run_scenes``
     in a process of its own, then ``scripts/cal.py`` over its output;
     it/s per stage, reader and sweep seconds, peak memory per run.
     ``python3 chip_smoke.py --phase 14`` runs the build and this phase
     alone and prints no result line.

Then the compositor launches of every phase that drives the port's
paths (4, 5, 5b, 6c, 7, 7b's replayed sweep, 8, 9, 10, 11, 12a-c, 13,
14a-c, 12b and 12c summed over both ranks; not the comparisons of 3, 6
and 6b),
the segment-sum, span-mark and hexplane launches of this process's phases
from 4 on but 6 and 6b (the bench's and the rank processes' run in their
own processes and are not counted), one JSON line with the kernels
(each one's launches over those phases; a span mark's device ms from
phase 13's profiles), the script's wall time, the card line, and last
``{"ok": true, "device": {...}}``.
The port imports no jax; neither does this script.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
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

# phase 7: the clip (tools/mini_clip.py's street scene at density 4, its
# camera rig, poses and gt_motion.json) and the CLI's cuts, depth and
# cadence only
CLIP_FRAMES, CLIP_DENSITY, CLIP_LIDAR, CLIP_SEED = 10, 4.0, 60_000, 0
CLIP_CAMS = 3                    # tools/mini_clip.py's CAM_YAWS
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
# phase 7b: a replayed sweep frame against the direct render, beyond the
# uint8 step (the render tolerance)
SWEEP_FRAME_ATOL = 5e-4
# phase 3b: the segment-sum kernel against its plain version, which adds
# in the same order (atol a share of the largest sum)
SEGSUM_ATOL = 1e-6
# phase 3c: the hexplane kernels at the benchmark's pool of 2,097,152 rows;
# the coordinate gradient's tolerance (its channel sums in another order)
HEX_ROWS, HEX_TIME = 2_097_152, 0.4
HEX_COORD_ATOL, HEX_COORD_RTOL = 1e-5, 1e-4
HEX_KERNELS = ("hexplane_fwd", "hexplane_bwd")
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
# phase 14: the reference's scene matrix on a longer clip of phase 7's
# street (frames 0-20, the clip's directory name its scene id): phase 1
# on frames 0-10, phase 2 on 11-20 from 14a's field, phase 9's cadence;
# stage2_nvs's stride cut so that its 10-frame window holds frame 20 out;
# the time limit of run_scenes' process
SCENE_CLIP, SCENE_FRAMES, SCENE_STAGE1_END = "street", 21, 10
SCENE_WINDOW, SCENE_NVS_STRIDE, SCENE_TIMEOUT_S = (11, 20), 9, 600
SCENE_COARSE, SCENE_FINE = PERF_COARSE, PERF_FINE
# phase 15: checkpoint interchange.  15a: phase 7's final checkpoint
# exported and imported again, --eval_only on the import against phase
# 8's, a block of fine steps resumed from each path; 15b: the JAX
# package's scene of tests/fixtures/jax_exchange_tiny.npz rendered on the
# card against JAX's render, then a block of fine steps on it
EXCHANGE_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                "jax_exchange_tiny.npz")
RESUME_STEPS, FIXTURE_STEPS = 10, 10
# phase 12: data parallelism on the one card.  12b: two gloo ranks at the
# headline, rank r's camera yawed DP_YAWS[r] (a rig of YAWS_DEG at
# DP_RIG_TIMES[r] for the rig steps); 12c: the CLI on phase 7's clip, depth
# cut further, a densify under DP in each stage
DP_WORLD, DP_REPS, DP_TIMEOUT_S = 2, 5, 300
DP_COARSE, DP_FINE, DP_RIG_STEPS = 2, 3, 3
DP_YAWS, DP_RIG_TIMES = (-40.0, 40.0), (0.4, 0.6)
DP_CLI_COARSE, DP_CLI_FINE, DP_CLI_DENSIFY_FROM = 20, 40, 10
DP_LABEL = "two ranks sharing one card, gloo: not a scaling figure"
# phase 13: steps a block of (a), rigs of 3 of (b), steps a block on
# either side of (c)'s densify, steps of (d)'s DP block; the cameras'
# fields of view in turn; steps profiled; the runtime calls the profiler
# counts as launches
GRAPH_BLOCK, GRAPH_RIGS, GRAPH_SPLIT, GRAPH_DP = 10, 3, 3, 5
GRAPH_FOVS = (0.9, 1.0, 1.1)
GRAPH_PROFILE = 2
# phase 13: how far a replayed block's spans may sum from its CUDA-event
# time (tests/test_torch_spans.py's gate)
SPAN_COVER = 0.05
# 13e: the two-class budget of the repeated rig step
REPEAT_BIG_BUDGET = 65_536
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def make_scene(torch, dev, n, cap, seed=0):
    """bench.py's "frustum" scene: LiDAR-like points in the view frustum,
    sized by create_from_pcd's 3-NN rule.  Returns the pool and the
    generator, advanced as bench.py's is before it draws the targets."""
    from s3gaussian_tpu_torch.bench import cloud
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    rng = np.random.default_rng(seed)
    pts, cols = cloud(n, "frustum", rng)
    return create_from_pcd(pts, cols, cap, device=dev), rng


def rig_camera(torch, dev, yaw_deg, t, h, w, image=None, depth_map=None,
               fov=1.0):
    """A rig camera at the ego centre looking along ``yaw`` (bench.py's
    FRONT_LEFT / FRONT / FRONT_RIGHT geometry) with a field of view of
    ``fov`` radians across and down; yaw 0 and fov 1 is bench.py's
    headline camera."""
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.ops.transforms import projection_matrix
    yaw = math.radians(yaw_deg)
    cy, sy = math.cos(yaw), math.sin(yaw)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]],
                            np.float32)
    full = (view @ projection_matrix(0.01, 100.0, fov, fov).T).astype(
        np.float32)

    def t_(x):
        return None if x is None else torch.tensor(x, device=dev)

    return Camera(world_view=t_(view), full_proj=t_(full),
                  campos=torch.zeros(3, device=dev),
                  time=torch.tensor(t, dtype=torch.float32, device=dev),
                  fovx=fov, fovy=fov, image_height=h, image_width=w,
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


def comp_since(before):
    """(forward, backward) compositor launches since ``before``, an earlier
    ``tk.compositor_launches()``."""
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    return tuple(n - n0 for n, n0 in zip(tk.compositor_launches(), before))


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
        opacity = torch.sigmoid(d.opacity)[:, 0]
        proj, feat_pool = rz.project_and_pack(
            settings, d.xyz, opacity, scales=torch.exp(d.scales),
            rotations=rot, colors_precomp=colors, alive=pool.alive, cfg=cfg)
        pk = rz.pair_keys(settings, proj, opacity, cfg)
        mark()
        gx, gy = rz.grid_dims(settings, cfg)
        b = rz.bin_pairs(pk, gx * gy, cfg.pair_budget)
        stream = rz.gather_stream(feat_pool, b, cfg.rect_cap)
        mark()
    return stream, b.tile_starts, gx, gy


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
        m = re.search(r"(composite_[a-z]+_kernel|segment_sum_kernelILi\d"
                      r"|hexplane_[a-z]+_kernelI(?:13__nv_bfloat16|f))", ln)
        if "entry function" in ln and m:
            name = (m[1].replace("ILi", "<").replace("I13__nv_", "<")
                    .replace("If", "<float") + (">" if "I" in m[1] else ""))
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


def segsum_phase(torch, su, card):
    """Phase 3b: the segment-sum kernel (``csrc/segment_sum.cu``, through
    ``ops/segsum.py::sum_ranges``) against its plain version
    (``ranges_torch``, on the card) on every call one eager headline fine
    step makes (the field's grid gradients: the first level of each
    plane's sums reads its rows through the sort's permutation): max abs
    error within SEGSUM_ATOL·max|plain|, the same bits on repeat.  Times
    the kernel, the plain version and the library call that computes the
    same sums (``index_add_`` of the rows by range, float32 atomics) on
    the largest call; its bound counts each value, permutation entry and
    offset read once and each sum written once (bytes), one float32 add a
    value (operations).  Returns the line's fields."""
    from s3gaussian_tpu_torch.ops import gridsample, segsum
    from s3gaussian_tpu_torch.train import trainer as tr

    calls = []
    orig = gridsample.sum_ranges

    def record(vals, perm, offs):
        calls.append(tuple(None if x is None else x.clone()
                           for x in (vals, perm, offs)))
        return orig(vals, perm, offs)

    state = tr.init_state(su.pool, su.deform, su.aabb)
    cam = rig_camera(torch, su.bg.device, 0.0, 0.4, H, W, su.gt, su.gt_depth)
    gridsample.sum_ranges = record
    try:
        tr.train_step(state, cam, "fine", 3, su.hp, su.opt, su.pipe, su.cfg,
                      SPATIAL_LR_SCALE, su.bg)
        torch.cuda.synchronize()
    finally:
        gridsample.sum_ranges = orig
    del state
    check(len(calls) > 0, "3b: the step made no segment sum")
    max_err = max_rel = 0.0
    for vals, perm, offs in calls:
        got = segsum.sum_ranges(vals, perm, offs)
        want = segsum.ranges_torch(vals, perm, offs)
        again = segsum.sum_ranges(vals, perm, offs)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "3b: segment_sum not deterministic")
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        check(err <= SEGSUM_ATOL * scale, f"3b: segment_sum differs from "
              f"its plain version by {err:.3e} (scale {scale:.3e}) on "
              f"{tuple(vals.shape)} rows, {offs.shape[0] - 1} ranges")
        max_err, max_rel = max(max_err, err), max(max_rel, err / scale)
    # the largest call: the first level of the plane with the most rows
    vals, perm, offs = max(calls, key=lambda c: (c[1] is not None,
                                                 c[0].numel()))
    k = perm.shape[0]
    n, d = offs.shape[0] - 1, vals.shape[1]
    ids = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                  offs[1:] - offs[:-1], output_size=k)
    rows = vals[perm]
    ms = cuda_ms(torch, lambda: segsum.sum_ranges(vals, perm, offs), reps=20)
    plain_ms = cuda_ms(torch, lambda: segsum.ranges_torch(vals, perm, offs),
                       reps=20)
    library_ms = cuda_ms(torch, lambda: torch.zeros(
        (n, d), device=vals.device).index_add_(0, ids, rows), reps=20)
    n_bytes = k * d * 4 + k * 8 + (n + 1) * 8 + n * d * 4
    bnd = bound(n_bytes, k * d)
    print(f"segment_sum vs plain: {len(calls)} calls of one headline fine "
          f"step, max abs err {max_err:.3e}, {max_rel:.3e} of max|plain| "
          f"(gate "
          f"{SEGSUM_ATOL}), the same bits on repeat; the largest call "
          f"({k} rows of {d} through the permutation into {n} ranges): "
          f"kernel {ms:.4f} ms, plain (torch.segment_reduce after the "
          f"gather) {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; "
          f"bound {n_bytes} bytes -> {bnd[0]:.4f} ms, set by {bnd[1]}; "
          f"kernel at {bnd[0] / ms:.3f} of it ({card})", flush=True)
    return {"max_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound": bnd}


def hexplane_phase(torch, su, card):
    """Phase 3c: the hexplane kernels (``csrc/hexplane.cu``, through
    ``models/hexplane.py::query_hexplane``) against the plain version
    (``query_hexplane_plain``, on the card) at HEX_ROWS rows in the
    headline aabb (a tenth of them beyond it) and the headline field's
    planes moved off their init, bfloat16 as the default field computes
    them: features and every plane's gradient bit for bit, the coordinate
    gradient within HEX_COORD_ATOL·max|plain| + HEX_COORD_RTOL·|plain|,
    a backward repeated bit for bit.

    Times the forward kernel alone and the four backward launches alone
    on the planes of ``gridsample.hexplane_layout``; the plain forward
    (under no_grad, its casts included) beside the kernels' forward with
    its layout; the plain backward (``autograd.grad`` on a saved plain
    forward: its segment sums included) beside the kernels' backward
    through autograd (segment sums, casts and the layout's backward
    included).  Each kernel's bound is the DRAM traffic its work requires
    at HBM rate: the coordinates, the cotangent and the outputs once a
    row, the laid-out planes once; the corner and pair-row gathers, which
    mostly hit L2, are printed beside it as a gather-traffic ceiling at
    HBM rate, not a bound.  Returns each kernel's fields."""
    from s3gaussian_tpu_torch.models import hexplane as hx
    from s3gaussian_tpu_torch.ops import gridsample as gs

    hp = su.hp
    n_scales = len(hp.multires)
    gen = torch.Generator(device=su.aabb.device).manual_seed(3)
    params = torch.nn.ParameterDict({
        k: torch.nn.Parameter(p.detach() + 0.1 * torch.randn(
            p.shape, generator=gen, device=p.device))
        for k, p in su.deform.grid.items()})
    lo, hi = su.aabb[1], su.aabb[0]
    pts = lo + (hi - lo) * (torch.rand((HEX_ROWS, 3), generator=gen,
                                       device=lo.device) * 1.1 - 0.05)
    t = torch.tensor(HEX_TIME, device=lo.device)
    c = params["scale0_plane0"].shape[0]
    cot = torch.randn((HEX_ROWS, c * n_scales), generator=gen,
                      device=lo.device)
    dtype = torch.bfloat16 if hp.grid_compute_bf16 else None
    wrt = list(params.values())

    def forward(query):
        p = pts.detach().requires_grad_(True)
        return p, query(params, p, t, su.aabb, n_scales, dtype)

    def run(query):
        p, out = forward(query)
        return (out.detach(),) + torch.autograd.grad(out, [p, *wrt], cot)

    got = run(hx.query_hexplane)
    again = run(hx.query_hexplane)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "3c: the hexplane kernels not deterministic")
    del again
    want = run(hx.query_hexplane_plain)
    torch.cuda.synchronize()
    fwd_err = float((got[0] - want[0]).abs().max())
    check(torch.equal(got[0], want[0]), f"3c: the hexplane features differ "
          f"from the plain version's by {fwd_err:.3e}")
    for name, a, b in zip(params.keys(), got[2:], want[2:]):
        check(torch.equal(a, b), f"3c: the gradient of {name} differs from "
              f"the plain version's by {float((a - b).abs().max()):.3e}")
    scale = float(want[1].abs().max())
    err = (got[1] - want[1]).abs()
    check(bool((err <= HEX_COORD_ATOL * scale
                + HEX_COORD_RTOL * want[1].abs()).all()),
          f"3c: the coordinate gradient differs by {float(err.max()):.3e} "
          f"(scale {scale:.3e})")
    coord_err = float(err.max())
    del got, want, err

    # the kernels alone on the laid-out planes
    x = hx.normalize_aabb(pts, su.aabb)
    planes = [params[f"scale{s}_plane{i}"].detach().to(dtype or torch.float32)
              for s in range(n_scales) for i in range(6)]
    with torch.no_grad():
        laid = gs.hexplane_layout(planes, t)
    dx = torch.empty_like(x)

    def backward():
        for s in range(n_scales):
            gs.hexplane_bwd(x, laid[6 * s:6 * s + 6], cot, s, dx, s > 0)

    ms = cuda_ms(torch, lambda: gs.hexplane_fwd(x, laid), reps=10)
    bwd_ms = cuda_ms(torch, backward, reps=5)
    with torch.no_grad():
        query_fwd_ms = cuda_ms(torch, lambda: hx.query_hexplane(
            params, pts, t, su.aabb, n_scales, dtype), reps=3, warmup=1)
        plain_fwd_ms = cuda_ms(torch, lambda: hx.query_hexplane_plain(
            params, pts, t, su.aabb, n_scales, dtype), reps=3, warmup=1)

    def grad_ms(query, reps):
        p, out = forward(query)
        return cuda_ms(torch, lambda: torch.autograd.grad(
            out, [p, *wrt], cot, retain_graph=True), reps=reps, warmup=1)

    query_bwd_ms = grad_ms(hx.query_hexplane, 3)
    plain_bwd_ms = grad_ms(hx.query_hexplane_plain, 2)
    e = laid[0].element_size()
    plane_bytes = sum(p.numel() * p.element_size() for p in laid)
    gathers = 12 * c * e + 3 * 2 * c * e          # a row, a scale
    # a row: its coordinates, then the features written
    fwd_rows = HEX_ROWS * (12 + n_scales * 4 * c)
    # a row, a scale: coordinates, cotangent; corner and pair cotangents
    # and their keys, dx (read again from the second scale on)
    bwd_rows = HEX_ROWS * (n_scales * (12 + 4 * c + 12 * 4 * c + 12 * 4
                                       + 6 * 4 * c + 3 * 4 + 12)
                           + (n_scales - 1) * 12)
    fwd_bound = bound(fwd_rows + plane_bytes, 0)
    bwd_bound = bound(bwd_rows + plane_bytes, 0)
    gathered = HEX_ROWS * n_scales * gathers
    fwd_ceil = bound(fwd_rows + gathered, 0)[0]
    bwd_ceil = bound(bwd_rows + gathered, 0)[0]
    print(f"hexplane kernels vs plain: {HEX_ROWS} rows, {n_scales} scales "
          f"of {c} channels, {dtype or torch.float32} planes "
          f"({plane_bytes} bytes laid out): features and every plane's "
          f"gradient bit for bit, coordinate gradient max abs err "
          f"{coord_err:.3e} (scale {scale:.3e}), the same bits on repeat; "
          f"forward kernel {ms:.4f} ms, DRAM bound "
          f"{fwd_rows + plane_bytes} bytes -> {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[0] / ms:.3f} of it), gather-traffic ceiling "
          f"{fwd_rows + gathered} bytes at HBM rate -> {fwd_ceil:.4f} ms; "
          f"backward kernels ({n_scales} launches) {bwd_ms:.4f} ms, DRAM "
          f"bound {bwd_rows + plane_bytes} bytes -> {bwd_bound[0]:.4f} ms "
          f"({bwd_bound[0] / bwd_ms:.3f} of it), gather-traffic ceiling "
          f"{bwd_rows + gathered} bytes -> {bwd_ceil:.4f} ms; the query's "
          f"forward {query_fwd_ms:.3f} ms (layout included) through the "
          f"kernels, {plain_fwd_ms:.3f} ms through the plain version; its "
          f"backward {query_bwd_ms:.3f} ms through the kernels, "
          f"{plain_bwd_ms:.3f} ms through the plain version (segment sums "
          f"included in both) ({card})", flush=True)
    del x, laid, dx, cot, pts, params, wrt
    torch.cuda.empty_cache()
    return {"hexplane_fwd": {"ms": ms, "plain_ms": plain_fwd_ms,
                             "bound": fwd_bound, "max_err": fwd_err},
            "hexplane_bwd": {"ms": bwd_ms, "plain_ms": plain_bwd_ms,
                             "bound": bwd_bound, "max_err": coord_err}}


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


def new_record():
    """What the hooks of ``cli_hooks`` record over one CLI run."""
    return {"reader_s": None, "scene": None, "densify_ms": [], "save_ms": [],
            "alloc": [], "evals": [], "splits": [], "video_s": [],
            "pair": None, "train_launches": None, "train_peak": None,
            "frames": None, "dispatches": [], "captures": [],
            "eval_args": None}


@contextlib.contextmanager
def cli_hooks(torch, rec):
    """Timing and counting wrappers around what ``train_cli.main`` and its
    eval sweep call, the environment the run reads (the log cadence, the
    LPIPS fixture weights); all restored afterwards."""
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.eval import video
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.train import graphs

    targets = {(train_cli, "load_scene"), (train_cli, "densify_step"),
               (train_cli, "train_step"), (train_cli, "train_step_multicam"),
               (train_cli, "train_steps_scan"),
               (train_cli, "train_steps_scan_multicam"),
               (graphs, "StepGraph"), (train_cli, "do_evaluation"),
               (ckpt, "save_checkpoint"), (video, "render_pixels"),
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
        def step(state, cam, *a, **k):
            res = orig[name](state, cam, *a, **k)
            # a block's views, and its stage after n_cams for the rigs
            stage = a[1] if name.endswith("scan_multicam") else a[0]
            rec["dispatches"].append(len(cam) if "scan" in name else 1)
            if res[0] is state:
                # a state that a densify or reset made anew, copied into
                # the graph's, is alive beside it until the caller drops it
                rec["alloc"].append((stage, torch.cuda.memory_allocated()))
            return res
        return step

    class CountedGraph(orig["StepGraph"]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["captures"].append((self.warmup_ms, self.capture_ms,
                                    tk.compositor_launches(self.captured)))

    def save_checkpoint(*a, **k):
        t = time.perf_counter()
        path = orig["save_checkpoint"](*a, **k)
        rec["save_ms"].append((time.perf_counter() - t) * 1e3)
        return path

    def do_evaluation(*a, **k):
        torch.cuda.synchronize()
        if rec["train_launches"] is None:
            rec["train_launches"] = tk.compositor_launches()
            rec["train_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        l0 = tk.compositor_launches()
        t = time.perf_counter()
        res = orig["do_evaluation"](*a, **k)
        torch.cuda.synchronize()
        # what the sweep rendered, for the replayed sweep's check
        rec["eval_args"] = (a, k)
        rec["evals"].append({
            "step": k["step"], "stage": a[9], "results": res,
            "s": time.perf_counter() - t,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": comp_since(l0)})
        return res

    def render_pixels(cams, *a, **k):
        t = time.perf_counter()
        stats = {}
        frames = orig["render_pixels"](cams, *a, stats=stats, **k)
        torch.cuda.synchronize()
        rec["splits"].append({
            "n": len(cams), "s": time.perf_counter() - t, "stats": stats,
            "frames": {key: len(v) for key, v in frames.items()
                       if isinstance(v, list)},
            "metrics": frames.get("metrics"),
            "per_view": frames.get("metrics_per_view")})
        if rec["frames"] is None:
            # the first split's frames and ground truth, for the offline
            # metrics tool
            rec["frames"] = {k: frames[k] for k in ("rgbs", "gt_rgbs")}
        return frames

    def save_videos(*a, **k):
        t = time.perf_counter()
        orig["save_videos"](*a, **k)
        rec["video_s"].append(time.perf_counter() - t)

    hooks = {"load_scene": load_scene, "densify_step": densify_step,
             "train_step": counted_step("train_step"),
             "train_step_multicam": counted_step("train_step_multicam"),
             "train_steps_scan": counted_step("train_steps_scan"),
             "train_steps_scan_multicam": counted_step(
                 "train_steps_scan_multicam"),
             "StepGraph": CountedGraph,
             "save_checkpoint": save_checkpoint,
             "do_evaluation": do_evaluation, "render_pixels": render_pixels,
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


def check_sweep(torch, rec, out, step, card, tag, splits=None, dx=True):
    """Gates of the one eval sweep ``rec`` holds and its printed numbers.
    ``splits`` maps each split, in the sweep's order, to its camera count
    (phase 7's clip: train and full, 30 each); ``dx`` says whether the
    field has a position head (without one there are no dynamic/static
    renders and no flow renders, nor flow renders in a split of one rig).
    Returns {split: per-view metrics} and the sweep's compositor
    launches."""
    splits = splits or {s: CLIP_FRAMES * CLIP_CAMS for s in SWEEP_SPLITS}
    ev = rec["evals"][-1]
    check(ev["step"] == step and ev["stage"] == "fine",
          f"{tag}: sweep at {ev['stage']} {ev['step']}, not fine {step}")
    check(list(ev["results"]) == list(splits),
          f"{tag}: sweep splits {list(ev['results'])}, not {list(splits)}")
    mdir = os.path.join(out, "eval", "metrics")
    per_view = {}
    recs = rec["splits"][-len(splits):]
    want_launches = [0, 0]
    for (split, n_cams), sp in zip(splits.items(), recs):
        n_rigs = n_cams // CLIP_CAMS
        has_flow = dx and n_rigs > 1
        # full, dynamic and static renders a camera, or the full alone
        per_cam = 3 if dx else 1
        keys = [k for k in SWEEP_FRAMES if (has_flow or "flows" not in k)
                and (dx or k in ("rgbs", "gt_rgbs", "depths"))]
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
            sp["frames"].get(k) == n_cams for k in keys) and not any(
            k in sp["frames"] for k in set(SWEEP_FRAMES) - set(keys)),
            f"{tag} {split}: frames {sp['frames']} for {sp['n']} cameras")
        vdir = os.path.join(out, "eval", f"{split}_set_{step}")
        written = set(os.listdir(vdir))
        for key in keys:
            pngs = {f"{key}_{i:03d}.png" for i in range(n_rigs)}
            check(f"{key}.mp4" in written or pngs <= written,
                  f"{tag} {split}: no video or PNGs of {key}")
        per_view[split] = sp["per_view"]
        st = sp["stats"]
        ovf = st["overflow"]
        check(ovf["overflow_visible"] == ovf["overflow_pairs"] == 0,
              f"{tag} {split}: a sweep render overflowed its budget: {ovf}")
        # one capture a kind of render, the rig's and the flow renders'
        # (3 cameras x full, dynamic and static; one camera)
        check([(w, launches) for w, _, _, launches in st["captures"]]
              == [("rig", (per_cam * CLIP_CAMS, 0))]
              + ([("flow", (1, 0))] if has_flow else []),
              f"{tag} {split}: captures {st['captures']}")
        n_flows = 2 * n_cams if has_flow else 0
        check(st["replays"] == n_rigs + n_flows,
              f"{tag} {split}: {st['replays']} replays for {n_rigs} rigs "
              f"and {n_flows} flow renders")
        # a replay counts what its graph captured; a capture's warm-up
        # render launches it once more
        want_launches[0] += n_cams * per_cam + n_flows + sum(
            c[3][0] for c in st["captures"])
    check(ev["launches"] == tuple(want_launches),
          f"{tag}: {ev['launches']} forward/backward launches in the sweep, "
          f"not {tuple(want_launches)}")
    print(f"{tag}: eval sweep at fine {step}: " + "; ".join(
        f"{split} {sp['n']} cameras {sp['s']:.3f} s, psnr "
        f"{m['psnr']:.3f} ssim {m['ssim']:.4f} lpips {m['lpips']:.4f} "
        f"masked psnr {m['masked_psnr']:.3f} ssim {m['masked_ssim']:.4f}"
        for split, sp, m in zip(splits, recs,
                                (ev["results"][s] for s in splits)))
        + f"; whole sweep {ev['s']:.3f} s ({card})", flush=True)
    print(f"{tag}: sweep per split (host clock): " + "; ".join(
        f"{split} {sp['s']:.3f} s = rig renders with their metrics "
        f"{sp['stats']['render_s']:.3f} s ({n // CLIP_CAMS} replays) + flow "
        f"renders {sp['stats']['flow_s']:.3f} s "
        f"({sp['stats']['replays'] - n // CLIP_CAMS} replays) + PNG/video "
        f"writing {vs:.3f} s, {sp['stats']['replays'] / (sp['stats']['render_s'] + sp['stats']['flow_s']):.2f} "
        f"replays/s; captures (warm-up ms, capture ms) " + ", ".join(
            f"{w} ({a:.1f}, {c:.1f})" for w, a, c, _ in sp["stats"]["captures"])
        for (split, n), sp, vs in zip(splits.items(), recs,
                                      rec["video_s"][-len(splits):]))
        + f"; peak device memory over the sweep {ev['peak'] / 2**30:.2f} GiB; "
        f"rect-clamped at most " + str(max(
            sp["stats"]["overflow"]["overflow_rect"] for sp in recs))
        + f" a render; {ev['launches'][0]} forward / {ev['launches'][1]} "
        f"backward compositor launches ({card})", flush=True)
    return per_view, ev["launches"]


def frame_err(torch, frame, img):
    """Largest distance of a sweep frame [H,W,3] (steps of 1/255) from
    the clipped float32 render [3,H,W] it quantises, beyond the half step
    of the quantisation."""
    want = torch.clamp(img, 0, 1).permute(1, 2, 0).double().cpu().numpy()
    return max(float(np.abs(frame - want).max()) - 0.5 / 255, 0.0)


def sweep_graph_phase(torch, rec, card):
    """Phase 7b: the sweep's renders as CUDA graphs against direct calls,
    on phase 7's final model and its train split (10 rigs of 3).  First
    one eager render of each kind the sweep captures (a rig with the
    decomposition and the metrics, a camera with flow colours) under
    ``torch.cuda.set_sync_debug_mode("error")``; then ``render_pixels``
    (replays) against ``render_multicam`` with the decomposition per rig
    and ``render`` with the flow colours of the direct renders' dx per
    camera: frames within SWEEP_FRAME_ATOL of the clipped render beyond
    the uint8 step (flow frames included), depths atol 5e-4 rtol 1e-4,
    every per-view metric within METRIC_ATOL of ``view_metrics`` of the
    direct render.  Prints the replays a second, the captures' ms, and
    for one rig render eager and replayed: ms (CUDA events), device
    operations, host launch calls and device ms.  Returns the replayed
    sweep's compositor launches."""
    from s3gaussian_tpu_torch.eval import video
    from s3gaussian_tpu_torch.eval.visualization import scene_flow_to_rgb
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.render.renderer import render, render_multicam
    from s3gaussian_tpu_torch.train import graphs

    a, _ = rec["eval_args"]
    cams, pool, deform, pipe, bg, aabb, sh, stage, cfg = (
        a[0], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10])
    env_before = os.environ.get("S3G_LPIPS_WEIGHTS")
    os.environ["S3G_LPIPS_WEIGHTS"] = LPIPS_FIXTURE
    try:
        groups = video.rig_groups(cams, CLIP_CAMS)
        check(groups is not None and len(groups) == CLIP_FRAMES,
              "7b: the train split is not laid out as rigs")
        # the kinds of render the sweep captures, eager, with no host sync
        rig_fn = video._sweep_render(pool, deform, pipe, bg, aabb, sh,
                                     stage, cfg, True, True, True, True)
        flow_fn = video._sweep_render(pool, deform, pipe, bg, aabb, sh,
                                      stage, cfg, False, False, False,
                                      False)
        rig = [video._slim(c, True) for c in groups[0]]
        one = [video._slim(cams[0], False)]
        colors = torch.rand((pool.capacity, 3), device=bg.device)
        with torch.no_grad():
            for check_sync in (False, True):
                torch.cuda.synchronize()
                if check_sync:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    rig_fn(rig)
                    flow_fn(one, override_color=colors)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

            # the replayed sweep
            stats = {}
            l0 = tk.compositor_launches()
            t0 = time.perf_counter()
            frames = video.render_pixels(cams, pool, deform, pipe, bg, aabb,
                                         sh, stage, cfg, stats=stats)
            sweep_s = time.perf_counter() - t0
            launches = comp_since(l0)
            want = (len(cams) * 5 + sum(c[3][0] for c in stats["captures"]),
                    0)
            check(launches == want, f"7b: {launches} launches, not {want}")
            check(graphs.current() is None, "7b: the sweep held its graph")

            # direct calls
            worst = {"frame": 0.0, "flow": 0.0, "depth": 0.0, "metric": 0.0}
            pv = frames["metrics_per_view"]
            dx = []
            direct_masked = {"masked_psnr": [], "masked_ssim": []}
            for r, g in enumerate(groups):
                pkg = render_multicam(g, pool, deform, pipe, bg, aabb, sh,
                                      stage=stage, return_decomposition=True,
                                      cfg=cfg)
                for b, cam in enumerate(g):
                    i = r * CLIP_CAMS + b
                    for key, img in (("rgbs", pkg["render"][b]),
                                     ("dynamic_rgbs", pkg["render_d"][b]),
                                     ("static_rgbs", pkg["render_s"][b])):
                        worst["frame"] = max(worst["frame"], frame_err(
                            torch, frames[key][i], img))
                    d = pkg["depth"][b].cpu().numpy()
                    err = np.abs(frames["depths"][i] - d)
                    check(bool((err <= 5e-4 + 1e-4 * np.abs(d)).all()),
                          f"7b: view {i} depth differs by {err.max():.3e}")
                    worst["depth"] = max(worst["depth"], float(err.max()))
                    vals = video.view_metrics(pkg["render"][b], cam)
                    for k in ("psnr", "ssim", "lpips"):
                        worst["metric"] = max(worst["metric"],
                                              abs(pv[k][i] - vals[k]))
                    for k in direct_masked:
                        if k in vals:
                            direct_masked[k].append(vals[k])
                    if rec["pair"] is None and bool(cam.dynamic_mask.any()):
                        # a frame whose mask has pixels, for the metric
                        # check on the card
                        rec["pair"] = (pkg["render"][b].clone(), cam)
                    dx.append(pkg["dx"])
            # the masked metrics: of the views whose mask has a pixel
            for k, v in direct_masked.items():
                check(len(v) == len(pv[k]), f"7b: {len(pv[k])} {k} values "
                      f"for {len(v)} masked views")
                for x, y in zip(pv[k], v):
                    worst["metric"] = max(worst["metric"], abs(x - y))
            n = len(cams)
            for i, cam in enumerate(cams):
                for key, j in (("forward_flows",
                                min(i + video.FLOW_OFFSET * CLIP_CAMS,
                                    n - 1)),
                               ("backward_flows",
                                max(i - video.FLOW_OFFSET * CLIP_CAMS, 0))):
                    colors = scene_flow_to_rgb(dx[j] - dx[i],
                                               flow_max_radius=2.0)
                    img = render(cam, pool, deform, pipe, bg, aabb, sh,
                                 stage=stage, override_color=colors,
                                 cfg=cfg)["render"]
                    worst["flow"] = max(worst["flow"], frame_err(
                        torch, frames[key][i], img))
            check(worst["frame"] <= SWEEP_FRAME_ATOL
                  and worst["flow"] <= SWEEP_FRAME_ATOL,
                  f"7b: replayed frames differ from direct renders: {worst}")
            check(worst["metric"] <= METRIC_ATOL,
                  f"7b: per-view metrics differ from direct ones: {worst}")

            # one rig render eager and replayed
            g = graphs.render_graph(("7b",), rig_fn, rig, {})
            ms_e = cuda_ms(torch, lambda: rig_fn(rig), reps=3, warmup=1)
            ms_g = cuda_ms(torch, lambda: g.run(rig), reps=10)
            dev_e, calls_e, kms_e, _ = profile_counts(
                torch, lambda: rig_fn(rig), 1)
            dev_g, calls_g, kms_g, _ = profile_counts(
                torch, lambda: g.run(rig), 1)
            cap = (g.warmup_ms, g.capture_ms)
            graphs.release()
    finally:
        if env_before is None:
            del os.environ["S3G_LPIPS_WEIGHTS"]
        else:
            os.environ["S3G_LPIPS_WEIGHTS"] = env_before
    print(f"7b: replayed sweep of the train split ({n} cameras, "
          f"{len(groups)} rigs) in {sweep_s:.3f} s: rig renders with their "
          f"metrics {stats['render_s']:.3f} s, {2 * n} flow renders "
          f"{stats['flow_s']:.3f} s, {stats['replays']} replays = "
          f"{stats['replays'] / (stats['render_s'] + stats['flow_s']):.2f} "
          f"replays/s; captures (warm-up ms, capture ms) " + ", ".join(
              f"{w} ({x:.1f}, {c:.1f})" for w, x, c, _ in stats["captures"])
          + f"; against direct render_multicam / render calls: frames "
          f"within {worst['frame']:.2e} and flow frames within "
          f"{worst['flow']:.2e} beyond the uint8 step (gate "
          f"{SWEEP_FRAME_ATOL}), depth {worst['depth']:.2e}, metrics "
          f"{worst['metric']:.2e} (gate {METRIC_ATOL}); one rig render "
          f"(3 cameras x full, dynamic, static, with metrics and LPIPS) "
          f"eager / replayed: {ms_e:.3f} / {ms_g:.3f} ms (CUDA events), "
          f"device operations {dev_e:.0f} / {dev_g:.0f}, host launch calls "
          f"{calls_e:.0f} / {calls_g:.0f} ({calls_e / CLIP_CAMS:.0f} / "
          f"{calls_g / CLIP_CAMS:.1f} a view), device ms {kms_e:.3f} / "
          f"{kms_g:.3f}; its capture: warm-up {cap[0]:.1f} ms, capture "
          f"{cap[1]:.1f} ms; {launches[0]} forward launches in the replayed "
          f"sweep ({card})", flush=True)
    return launches


def eval_only_phase(torch, argv, out, per_view7, card):
    """Phase 8: ``--eval_only`` on phase 7's model path restores the final
    fine checkpoint and reproduces the final sweep's per-view metrics; on
    a fresh model path it refuses.  Returns the sweep's launches."""
    from s3gaussian_tpu_torch import train_cli

    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    rec = new_record()
    t0 = time.time()
    with cli_hooks(torch, rec):
        tk.reset("composite_fwd", "composite_bwd")
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
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.tools.mini_clip import gt_scene, write_clip
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.utils.ply import read_ply

    root = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    clip, out = os.path.join(root, "clip"), os.path.join(root, "out")
    t0 = time.time()
    scene = gt_scene(np.random.default_rng(CLIP_SEED), density=CLIP_DENSITY)
    # every Gaussian may be visible: no ground-truth render drops one
    overflow, n_lidar = write_clip(
        clip, scene, CLIP_FRAMES, H, W, np.random.default_rng(CLIP_SEED + 1),
        lidar_cap=CLIP_LIDAR, cfg=RasterConfig(
            max_visible=len(scene["pts"]), rect_w=6, rect_h=6,
            pair_budget=1 << 23), device=dev)
    check(overflow["overflow_visible"] == overflow["overflow_pairs"] == 0,
          f"ground-truth renders overflowed their budgets: {overflow}")
    print(f"clip: {CLIP_FRAMES} frames x {CLIP_CAMS} cameras {H}x{W}, "
          f"ground truth from {len(scene['pts'])} gaussians (density "
          f"{CLIP_DENSITY}; rects clamped to 6x6 tiles over the "
          f"{CLIP_FRAMES * CLIP_CAMS} renders: "
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
        tk.reset("composite_fwd", "composite_bwd")
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
    n_steps, dispatch = CLI_COARSE + CLI_FINE, dispatches(rec, 1, "cli")
    check(launches == (n_steps + len(rec["captures"]),) * 2,
          f"{launches} forward/backward launches for {n_steps} train steps "
          f"and {len(rec['captures'])} captures' warm-up steps")
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
    check(n_cams == CLIP_FRAMES * CLIP_CAMS, f"cameras.json: {n_cams}")
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
          f"backward launches; alive {n_ckpt} in the checkpoint and the PLY; "
          f"{dispatch} ({card})", flush=True)
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


def dispatches(rec, cams, what):
    """Gates on the CLI's dispatches that ``cli_hooks`` recorded: every
    one through the captured step (blocks of the default 10 and single
    steps), one capture a stage, each capture with one forward and one
    backward launch a camera.  Returns their summary line."""
    blocks = rec["dispatches"]
    caps = rec["captures"]
    check(len(caps) == 2 and all(c[2] == (cams, cams) for c in caps),
          f"{what}: captures (warm-up ms, capture ms, launches) {caps}: "
          f"not one a stage with {cams} launch(es) of each kernel")
    check(blocks.count(10) > 0 and set(blocks) <= {1, 10},
          f"{what}: dispatches of {sorted(set(blocks))} steps")
    return (f"{len(blocks)} dispatches ({blocks.count(10)} blocks of 10, "
            f"{blocks.count(1)} single steps) through the captured step; "
            f"captures (warm-up, capture ms) " + ", ".join(
                f"({w:.1f}, {c:.1f})" for w, c, _ in caps))


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
        l0 = tk.compositor_launches()
        res.append(tr.train_step_multicam(st, cams, "fine", 3, hp, opt, pipe,
                                          cfg, SPATIAL_LR_SCALE, b))
        got = comp_since(l0)
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
        l0 = tk.compositor_launches()
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
        got = comp_since(l0)
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
                              su.opt, SPATIAL_LR_SCALE)
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
    l0 = tk.compositor_launches()
    state, aux, ms = timed_rig_steps(torch, state,
                                     rigs[:RIG_WARMUP + RIG_STEPS], su,
                                     su.cfg, RIG_WARMUP, "rig step")
    launches = comp_since(l0)
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
    from s3gaussian_tpu_torch.bench import cloud
    rng = np.random.default_rng(seed)
    return (*cloud(n, "street360", rng), rng)


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
    l0 = tk.compositor_launches()
    n_timed = WAYMO_WARMUP + WAYMO_STEPS
    try:
        state, aux, ms = timed_rig_steps(torch, state, rigs[:n_timed], su,
                                         cfg, WAYMO_WARMUP, "waymo rig")
        launches = comp_since(l0)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        state, split = rig_split(torch, state, rigs[n_timed:], su, cfg)
        # 13e: the Waymo rig's step repeats bit for bit
        repeat_step(torch, state, tr.train_step_multicam, rigs[0],
                    ("fine", 3, su.hp, su.opt, su.pipe, cfg,
                     SPATIAL_LR_SCALE, su.bg), "waymo rig, cull", card)
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
            tk.reset("composite_fwd", "composite_bwd")
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
    dispatch = dispatches(rec, 3, "waymo_perf")
    check(launches == (3 * (n_steps + len(rec["captures"])),) * 2,
          f"waymo_perf: {launches} forward/backward launches for {n_steps} "
          f"rig steps of 3 cameras and {len(rec['captures'])} captures' "
          f"warm-up steps")
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
          f"{rec['train_peak'] / 2 ** 30:.2f} GiB; {dispatch} ({card})",
          flush=True)
    _, sweep = check_sweep(torch, rec, out, int(state.step), card,
                           "waymo_perf")
    return launches, sweep


def tools_phase(torch, out, rec7, card):
    """Phase 10: the offline tools on phase 7's model path.
    ``eval_per_view`` (every train view rendered again from the restored
    checkpoint: its mean PSNR is the final sweep's train-split mean),
    ``eval_flow_epe`` (finite EPE at every probe frame and offset) and
    ``tools/metrics.py`` on a ``test/<method>/{renders,gt}`` directory
    written from the sweep's train-split frames.  Returns the compositor
    launches of the three."""
    from s3gaussian_tpu_torch.data.images import write_png
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.tools import eval_flow_epe, eval_per_view
    from s3gaussian_tpu_torch.tools import metrics as metrics_tool

    n_views = CLIP_FRAMES * CLIP_CAMS
    buf = io.StringIO()
    tk.reset("composite_fwd", "composite_bwd")
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        pv = eval_per_view.main(["--model_path", out])
    pv_s = time.time() - t0
    sweep_mean = rec7["evals"][-1]["results"]["train"]["psnr"]
    check(pv["n_views"] == n_views, f"eval_per_view: {pv['n_views']} views")
    check(abs(pv["mean"] - sweep_mean) <= 1e-4,
          f"eval_per_view mean psnr {pv['mean']} vs the final sweep's "
          f"train-split {sweep_mean}")
    # one render a camera (the rigs, no decomposition), two flow renders;
    # the warm-up renders of the rig's and the flow renders' captures
    check(tk.compositor_launches() == (3 * n_views + CLIP_CAMS + 1, 0),
          f"eval_per_view: {tk.compositor_launches()} launches")

    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        epe = eval_flow_epe.main(["--model_path", out])
    epe_s = time.time() - t0
    probes = [0, CLIP_FRAMES // 3, 2 * CLIP_FRAMES // 3]
    want = {f"t{t}_off{o}" for t in probes for o in (1, 3)
            if t + o < CLIP_FRAMES}
    check(set(epe) == want, f"eval_flow_epe: entries {sorted(epe)}")
    for key, r in epe.items():
        check(all(isinstance(r[k], float) and math.isfinite(r[k])
                  for k in ("epe_dynamic", "epe_static")),
              f"eval_flow_epe {key}: {r}")

    mroot = os.path.join(os.path.dirname(out), "metrics_tool")
    shutil.rmtree(mroot, ignore_errors=True)
    for sub, key in (("renders", "rgbs"), ("gt", "gt_rgbs")):
        d = os.path.join(mroot, "test", "ours", sub)
        os.makedirs(d)
        for i, img in enumerate(rec7["frames"][key]):
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
            write_png(os.path.join(d, f"{i:05d}.png"), img, level=1)
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        scores = metrics_tool.main(["-m", mroot])
    m_s = time.time() - t0
    res = scores[mroot]["ours"]
    with open(os.path.join(mroot, "per_view.json")) as f:
        per_view = json.load(f)["ours"]
    check(all(math.isfinite(res[k]) for k in ("PSNR", "SSIM"))
          and res["LPIPS"] is None,
          f"metrics tool: {res} (LPIPS is null without VGG weights)")
    check(all(len(per_view[k]) == n_views
              and all(math.isfinite(v) for v in per_view[k].values())
              for k in ("PSNR", "SSIM")),
          f"metrics tool: per-view entries {[len(v) for v in per_view.values()]}")
    launches = tk.compositor_launches()
    print(f"tools: eval_per_view {pv['n_views']} views in {pv_s:.2f} s, mean "
          f"psnr {pv['mean']:.6f} (the final sweep's train split "
          f"{sweep_mean:.6f}, gate 1e-4), median {pv['median']:.3f} p10 "
          f"{pv['p10']:.3f} p90 {pv['p90']:.3f}; eval_flow_epe {len(epe)} "
          f"entries in {epe_s:.2f} s: " + " ".join(
              f"{k} dyn {r['epe_dynamic']:.4f} static {r['epe_static']:.4f}"
              f" (n {r['n_dynamic']})" for k, r in sorted(epe.items()))
          + f"; metrics.py on the sweep's {n_views} train frames in "
          f"{m_s:.2f} s: PSNR {res['PSNR']:.4f} SSIM {res['SSIM']:.4f} "
          f"LPIPS {res['LPIPS']}; {launches[0]} forward / {launches[1]} "
          f"backward launches ({card})", flush=True)
    return launches


def with_flag(argv, flag, value):
    """``argv`` with ``flag`` set to ``value`` (replaced where present)."""
    argv = list(argv)
    if flag in argv:
        argv[argv.index(flag) + 1] = value
        return argv
    return argv + [flag, value]


def split_frames(out, step):
    """{file: uint8 array} of the PNG frames a sweep at ``step`` wrote
    under ``out``."""
    from s3gaussian_tpu_torch.data.images import decode_png
    frames = {}
    for split in SWEEP_SPLITS:
        d = os.path.join(out, "eval", f"{split}_set_{step}")
        for name in sorted(os.listdir(d)):
            if name.endswith(".png"):
                with open(os.path.join(d, name), "rb") as f:
                    frames[f"{split}/{name}"] = decode_png(f.read())
    return frames


def exchange_phase(torch, dev, argv7, out7, rec8, card):
    """Phase 15: checkpoint interchange on the card.  15a: phase 7's final
    checkpoint exported to an exchange file and imported under a new
    model path (every tensor bit for bit), ``--eval_only`` on the import
    (phase 8's metrics within METRIC_ATOL, its frames within one uint8
    step), a block of RESUME_STEPS fine steps resumed through
    ``--start_checkpoint`` from each path (the two states bit for bit).
    15b: the JAX package's scene of the committed fixture imported, its
    camera rendered through the CUDA compositor against JAX's float32
    render (phase 6's gate: RGBD_ATOL/RTOL, at most MAX_FLIPPED_PIXELS
    pixels beyond it, each behind a pair on a threshold between the
    card's stream and the CPU's), then a block of FIXTURE_STEPS fine steps
    on it (finite losses, every pool group moved).  Returns
    {run: compositor launches}."""
    from types import SimpleNamespace

    from s3gaussian_tpu_torch import config as tcfg
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.data.cameras import Camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.render.renderer import render
    from s3gaussian_tpu_torch.tools import exchange
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train.trainer import train_steps_scan

    t15 = time.time()
    root = os.path.join(REPO, "build", "chip_smoke_exchange")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches = {}
    buf = io.StringIO()

    # 15a. across and back
    src = os.path.join(out7, f"chkpnt_fine_{CLI_FINE}")
    npz, imported = os.path.join(root, "phase7.npz"), os.path.join(root,
                                                                   "imported")
    tk.reset("composite_fwd", "composite_bwd")
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        exchange.export_run(out7, npz, src)
    export_s = time.time() - t0
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        state = exchange.import_run(npz, imported)
    torch.cuda.synchronize()
    import_s = time.time() - t0
    check(tk.compositor_launches() == (0, 0),
          "15a: the export or import launched a kernel")
    alive = int(state.pool.n_alive)
    del state
    want = torch.load(os.path.join(src, ckpt.STATE_FILE), map_location="cpu",
                      weights_only=True)
    dst = os.path.join(imported, f"chkpnt_fine_{CLI_FINE}")
    got = torch.load(os.path.join(dst, ckpt.STATE_FILE), map_location="cpu",
                     weights_only=True)
    check(got.keys() == want.keys(), f"15a: the imported state's keys "
          f"differ: {sorted(set(got) ^ set(want))[:4]}")
    for k, v in want.items():
        check(got[k].dtype == v.dtype and torch.equal(got[k], v),
              f"15a: {k} of the imported state differs from phase 7's")
    check(ckpt.read_stage(dst) == ckpt.read_stage(src),
          f"15a: STAGE {ckpt.read_stage(dst)}")
    n_bytes = sum(v.numel() * v.element_size() for v in want.values())
    print(f"15a: phase 7's chkpnt_fine_{CLI_FINE} ({len(want)} tensors, "
          f"{n_bytes} bytes, {alive} alive of {want['pool.xyz'].shape[0]}) "
          f"-> exchange file {os.path.getsize(npz)} bytes in {export_s:.2f} s "
          f"-> imported in {import_s:.2f} s (built and saved on the CPU, "
          f"then restored on the card); every tensor bit for bit ({card})",
          flush=True)
    del want, got

    # --eval_only on the import against phase 8's
    argv_i = with_flag(argv7, "--model_path", imported)
    rec = new_record()
    with cli_hooks(torch, rec):
        tk.reset("composite_fwd", "composite_bwd")
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            state = train_cli.main(argv_i + ["--eval_only"])
        torch.cuda.synchronize()
        eval_s = time.time() - t0
    step = int(state.step)
    del state
    per_view, launches["15a --eval_only"] = check_sweep(
        torch, rec, imported, step, card, "15a eval_only")
    want_pv = {sp: r["per_view"] for sp, r in zip(SWEEP_SPLITS,
                                                  rec8["splits"][-2:])}
    worst = 0.0
    for split, want_split in want_pv.items():
        m_got = rec["evals"][-1]["results"][split]
        m_want = rec8["evals"][-1]["results"][split]
        check(m_got.keys() == m_want.keys(), f"15a {split}: metric keys")
        pairs = [(m_got[k], m_want[k]) for k in m_want]
        for k, w in want_split.items():
            check(len(per_view[split][k]) == len(w), f"15a {split} {k}")
            pairs += list(zip(per_view[split][k], w))
        for g, w in pairs:
            check((g is None) == (w is None)
                  and (g is None or abs(g - w) <= METRIC_ATOL),
                  f"15a {split}: --eval_only on the import gave {g}, phase "
                  f"8 {w}")
            if g is not None:
                worst = max(worst, abs(g - w))
    frames_i = split_frames(imported, step)
    frames_8 = split_frames(out7, step)
    check(frames_i.keys() == frames_8.keys() and frames_i,
          f"15a: frames {len(frames_i)} against phase 8's {len(frames_8)}")
    n_diff, frame_worst = 0, 0
    for k, a in frames_8.items():
        d = np.abs(frames_i[k].astype(np.int16) - a.astype(np.int16))
        n_diff += int((d > 0).sum())
        frame_worst = max(frame_worst, int(d.max()))
    check(frame_worst <= 1, f"15a: a frame differs by {frame_worst} uint8 "
          f"steps from phase 8's")
    print(f"15a: --eval_only on the import in {eval_s:.2f} s: metrics and "
          f"per-view values against phase 8's, worst difference {worst:.3e} "
          f"(gate {METRIC_ATOL}); {len(frames_i)} frames, {n_diff} uint8 "
          f"values differ, by at most {frame_worst} (gate 1) ({card})",
          flush=True)

    # a block of fine steps resumed from each path
    resumed = {}
    for tag, path in (("phase 7", src), ("import", dst)):
        model = os.path.join(root, f"resumed_{len(resumed)}")
        argv_r = with_flag(with_flag(argv7, "--model_path", model),
                           "--iterations", str(CLI_FINE + RESUME_STEPS))
        rec = new_record()
        with cli_hooks(torch, rec):
            tk.reset("composite_fwd", "composite_bwd")
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                train_cli.main(argv_r + ["--start_checkpoint", path,
                                         "--skip_final_eval"])
            torch.cuda.synchronize()
            run_s = time.time() - t0
        graphs.release()
        key = f"15a resumed from {tag}"
        launches[key] = tk.compositor_launches()
        check(launches[key] == (RESUME_STEPS + len(rec["captures"]),) * 2
              and len(rec["captures"]) == 1,
              f"{key}: {launches[key]} launches, {len(rec['captures'])} "
              f"captures")
        resumed[tag] = (torch.load(os.path.join(
            model, f"chkpnt_fine_{CLI_FINE + RESUME_STEPS}", ckpt.STATE_FILE),
            map_location="cpu", weights_only=True), run_s)
    (a, a_s), (b, b_s) = resumed.values()
    check(a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
        "15a: the blocks resumed from phase 7's checkpoint and from the "
        "import end in different states")
    check(int(a["step"]) == CLI_FINE + RESUME_STEPS, f"15a: step {a['step']}")
    print(f"15a: {RESUME_STEPS} fine steps resumed from phase 7's "
          f"checkpoint ({a_s:.2f} s) and from the import ({b_s:.2f} s), one "
          f"capture each: the two states bit for bit over {len(a)} tensors "
          f"({card})", flush=True)
    del a, b, resumed

    # 15b. a scene the JAX package trained, on the card
    with np.load(EXCHANGE_FIXTURE, allow_pickle=False) as z:
        z = dict(z)
    tiny_npz = os.path.join(root, "jax_tiny.npz")
    with open(tiny_npz, "wb") as f:
        f.write(z["exchange"].tobytes())
    tiny = os.path.join(root, "jax_tiny")
    with contextlib.redirect_stdout(buf):
        state = exchange.import_run(tiny_npz, tiny)
    with open(os.path.join(tiny, "cfg_args")) as f:
        ns = SimpleNamespace(**ast.literal_eval(f.read()))
    hp, opt, pipe, cfg = (tcfg.extract_group(c, ns) for c in (
        tcfg.ModelHiddenParams, tcfg.OptimizationParams,
        tcfg.PipelineParams, tcfg.RasterConfig))
    sh = int(z["sh_degree"])

    def camera(device, **maps):
        def t(k):
            return torch.as_tensor(z[f"camera/{k}"], device=device)
        return Camera(world_view=t("world_view"), full_proj=t("full_proj"),
                      campos=t("campos"), time=t("time"),
                      fovx=float(z["camera/fovx"]),
                      fovy=float(z["camera/fovy"]),
                      image_height=int(z["camera/height"]),
                      image_width=int(z["camera/width"]), **maps)
    cam = camera(dev)
    bg = torch.zeros(3, device=dev)
    tk.reset("composite_fwd", "composite_bwd")
    with torch.no_grad():
        g = render(cam, state.pool, state.deform, pipe, bg, state.aabb, sh,
                   "fine", cfg=cfg)
    torch.cuda.synchronize()
    render_launches = tk.compositor_launches()
    check(render_launches == (1, 0), f"15b: {render_launches} launches")
    h, w = cam.image_height, cam.image_width
    bad = torch.zeros(h, w, dtype=torch.bool)
    pixel_err = torch.zeros(h, w, dtype=torch.float64)
    for key, ref in (("render", z["render/rgb"]), ("depth",
                                                   z["render/depth"])):
        ref = torch.from_numpy(ref).double()
        err = (g[key].cpu().double() - ref).abs()
        over = ~(err <= RGBD_ATOL + RGBD_RTOL * ref.abs())
        bad |= over.any(0) if over.dim() == 3 else over
        pixel_err = torch.maximum(pixel_err,
                                  err.amax(0) if err.dim() == 3 else err)
    worst_rest = float(pixel_err[~bad].max())
    ys, xs = torch.nonzero(bad, as_tuple=True)
    flipped = []
    if len(ys):
        cpu_state = ckpt.read_checkpoint(
            tiny_ckpt(tiny), DeformationField(
                hp, torch.Generator().manual_seed(0), "cpu"),
            torch.device("cpu"))[0]
        sg = fine_stream(torch, cam, state.pool, state.deform, bg,
                         state.aabb, cfg)
        sc = fine_stream(torch, camera("cpu"), cpu_state.pool,
                         cpu_state.deform, bg.cpu(), cpu_state.aabb, cfg)
        for y, x in list(zip(ys.tolist(), xs.tolist()))[
                :MAX_FLIPPED_PIXELS + 1]:
            tile = (y // cfg.tile_y) * sg[2] + x // cfg.tile_x
            flips = threshold_flips(
                torch, pixel_trace(torch, sg[0], sg[1], tile, x, y),
                pixel_trace(torch, sc[0], sc[1], tile, x, y))
            flipped.append((x, y, float(pixel_err[y, x]), flips[:1]))
        for x, y, e, f in flipped:
            print(f"  15b: pixel ({x}, {y}) err {e:.3e} against JAX's "
                  f"render; first differing decision, card vs CPU: {f}",
                  flush=True)
    check(len(ys) <= MAX_FLIPPED_PIXELS and all(
        f and f[0][0] != "unexplained" for *_, f in flipped),
        f"15b: {len(ys)} pixels beyond tolerance of JAX's render (max abs "
        f"{float(pixel_err.max()):.3e}; at most {MAX_FLIPPED_PIXELS}, each "
        f"behind a pair on a threshold)")
    print(f"15b: the JAX package's scene ({int(state.pool.n_alive)} alive of "
          f"{state.pool.capacity}, written by the JAX package on the CPU) "
          f"rendered on the card at {h}x{w}: {len(ys)} pixels beyond "
          f"{RGBD_ATOL} / rtol {RGBD_RTOL} of JAX's float32 render (each "
          f"behind a pair on a threshold), max abs err elsewhere "
          f"{worst_rest:.3e} ({card})", flush=True)

    # a block of fine steps on the JAX-made state, against JAX's render
    target = camera(dev, image=torch.as_tensor(
        z["render/rgb"], device=dev).permute(1, 2, 0).contiguous(),
        depth_map=torch.as_tensor(z["render/depth"], device=dev))
    before = {k: v.clone() for k, v in state.pool.param_dict().items()}
    tk.reset("composite_fwd", "composite_bwd")
    state, aux = train_steps_scan(state, [target] * FIXTURE_STEPS, "fine", sh,
                                  hp, opt, pipe, cfg, 5.0, bg)
    torch.cuda.synchronize()
    graphs.release()
    fwd, bwd = tk.compositor_launches()
    launches["15b render + steps"] = (fwd + render_launches[0], bwd)
    loss = aux["metrics"]["loss"].cpu()
    check(bool(torch.isfinite(loss).all()), f"15b: losses {loss.tolist()}")
    check(tk.compositor_launches() == (FIXTURE_STEPS + 1,) * 2,
          f"15b: {tk.compositor_launches()} launches for "
          f"{FIXTURE_STEPS} steps and a capture's warm-up")
    moved = [k for k, v in state.pool.param_dict().items()
             if not torch.equal(v, before[k])]
    check(len(moved) == len(before), f"15b: only {moved} moved")
    print(f"15b: {FIXTURE_STEPS} fine steps on the JAX-made state (replays "
          f"of one capture): loss {float(loss[0]):.6f} -> "
          f"{float(loss[-1]):.6f}, every pool group moved; phase 15 in "
          f"{time.time() - t15:.1f} s ({card})", flush=True)
    del state
    return launches


def tiny_ckpt(model_path):
    """The one checkpoint directory under ``model_path``."""
    return next(os.path.join(model_path, d) for d in os.listdir(model_path)
                if d.startswith("chkpnt_"))


def merged_preset(name, path, model, opt):
    """``arguments/<name>`` with its ModelParams and OptimizationParams
    values replaced by ``model`` and ``opt`` (the window, the stride,
    the cadence), written to ``path``; every other key kept."""
    preset = {}
    with open(os.path.join(REPO, "arguments", name)) as f:
        exec(f.read(), preset)
    groups = {"ModelParams": model, "OptimizationParams": opt}
    with open(path, "w") as f:
        for group in ("ModelParams", "OptimizationParams", "PipelineParams",
                      "ModelHiddenParams", "RasterConfig"):
            if group in preset or group in groups:
                values = dict(preset.get(group, {}), **groups.get(group, {}))
                f.write(f"{group} = {values!r}\n")
    return path


def run_group(cmd, env, timeout):
    """``cmd`` from the repository root in a process group of its own,
    its output captured; the whole group is killed if it outlasts
    ``timeout`` (seconds), the processes it started with it."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def scene_run(torch, argv, tag, card, splits=None, dx=True):
    """One run of phase 14 through ``train_cli.main`` in this process
    under ``cli_hooks``: phase 7's training gates (finite losses, no
    overflow, the logged cadence, densifies that clone or split and
    prune, one forward and one backward launch a step and a capture's
    warm-up, one capture a stage, the final checkpoint and PLY, memory
    after a fine step), then with ``splits`` the final sweep's
    (``check_sweep``).  Prints it/s per stage, reader s, sweep s per
    split and peak memory, and what was allocated before the run.
    Returns (state, record, printed output, compositor launches of
    training and sweep)."""
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.utils.ply import read_ply

    out = argv[argv.index("--model_path") + 1]
    rec = new_record()
    # the previous run's record and state can sit in reference cycles
    # (cli_hooks makes a class a run), and cuBLAS keeps a workspace for
    # every stream it ran on, each capture running on a side stream of
    # its own: both freed here, so that the run's peak is its own
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with cli_hooks(torch, rec), contextlib.redirect_stdout(buf):
            tk.reset("composite_fwd", "composite_bwd")
            state = train_cli.main(argv)
            torch.cuda.synchronize()
    except BaseException:
        print(buf.getvalue(), end="", flush=True)
        raise
    run_s = time.time() - t0
    printed = buf.getvalue()
    graphs.release()
    launches = rec["train_launches"] or tk.compositor_launches()
    peak = (rec["train_peak"] if rec["train_peak"] is not None
            else torch.cuda.max_memory_allocated())

    log = read_logger(os.path.join(out, "logger.json"))
    steps = [l for l in log if "Loss" in l]
    for l in steps:
        where = f"{tag} {l['stage']} step {l['step']}"
        check(math.isfinite(l["Loss"]), f"{where}: Loss {l['Loss']}")
        check(l["ovf_vis"] == l["ovf_pairs"] == 0,
              f"{where}: overflow visible {l['ovf_vis']} pairs "
              f"{l['ovf_pairs']}")
        check(l["nan_skips"] == 0, f"{where}: nan_skips {l['nan_skips']}")
    want_steps = [(stage, i) for stage, n in (("coarse", SCENE_COARSE),
                                              ("fine", SCENE_FINE))
                  for i in [1] + list(range(CLI_LOG_EVERY, n + 1,
                                            CLI_LOG_EVERY))]
    check([(l["stage"], l["step"]) for l in steps] == want_steps,
          f"{tag}: logged steps {[(l['stage'], l['step']) for l in steps]}")
    dens = [l for l in log if "densify" in l]
    check(any(d["densify"]["n_cloned"] + d["densify"]["n_split"] > 0
              for d in dens), f"{tag}: no densify cloned or split")
    check(any(d["densify"]["n_pruned"] > 0 for d in dens),
          f"{tag}: nothing pruned")
    check(all(d["densify"]["overflow"] == 0 for d in dens),
          f"{tag}: a densify ran out of free slots")
    n_steps = SCENE_COARSE + SCENE_FINE
    dispatch = dispatches(rec, 1, tag)
    check(launches == (n_steps + len(rec["captures"]),) * 2,
          f"{tag}: {launches} forward/backward launches for {n_steps} train "
          f"steps and {len(rec['captures'])} captures' warm-up steps")
    check(sorted(d for d in os.listdir(out) if d.startswith("chkpnt_"))
          == [f"chkpnt_fine_{SCENE_FINE}"], f"{tag}: checkpoints left")
    flat = torch.load(os.path.join(out, f"chkpnt_fine_{SCENE_FINE}",
                                   ckpt.STATE_FILE), weights_only=True)
    n_ply = len(read_ply(os.path.join(out, "point_cloud",
                                      f"iteration_{SCENE_FINE}",
                                      "point_cloud.ply"))["x"])
    check(int(flat["pool.alive"].sum()) == n_ply == int(state.pool.n_alive),
          f"{tag}: alive in the checkpoint {int(flat['pool.alive'].sum())}, "
          f"PLY {n_ply}, state {int(state.pool.n_alive)}")
    fine_alloc = [a for s, a in rec["alloc"] if s == "fine"]
    half = len(fine_alloc) // 2
    check(max(fine_alloc[half:]) <= (1 + ALLOC_GROWTH) * max(fine_alloc[:half]),
          f"{tag}: device memory after a fine step grew from "
          f"{max(fine_alloc[:half])} to {max(fine_alloc[half:])} bytes")
    rates = {s: [l for l in steps if l["stage"] == s][-1]["it_per_s"]
             for s in ("coarse", "fine")}
    sc = rec["scene"]
    print(f"{tag}: {len(sc.get_train_cameras())} train / "
          f"{len(sc.get_test_cameras())} test cameras, reader "
          f"{rec['reader_s']:.2f} s; it/s coarse {rates['coarse']} fine "
          f"{rates['fine']}; training peak {peak / 2 ** 30:.2f} GiB, "
          f"{held / 2 ** 30:.2f} GiB of it held before the run "
          f"({left / 2 ** 30:.2f} GiB before cuBLAS's workspaces were "
          f"freed, after a garbage collection); "
          f"densify " + " ".join(
              f"{d['stage'][0]}{d['step']}:+{d['densify']['n_cloned']}"
              f"+{d['densify']['n_split']}-{d['densify']['n_pruned']}"
              f"->{d['densify']['n_alive']}" for d in dens)
          + f"; fine psnr {steps[-1]['psnr']} dB; {launches[0]} forward / "
          f"{launches[1]} backward launches; {dispatch}; run {run_s:.2f} s "
          f"({card})", flush=True)
    sweep = (0, 0)
    if splits is not None:
        check(len(rec["evals"]) == 1, f"{tag}: {len(rec['evals'])} sweeps")
        _, sweep = check_sweep(torch, rec, out, int(state.step), card, tag,
                               splits=splits, dx=dx)
    else:
        check(not rec["evals"], f"{tag}: {len(rec['evals'])} sweeps")
    return state, rec, printed, (launches[0] + sweep[0],
                                 launches[1] + sweep[1])


def scene_matrix_phase(torch, dev, card):
    """Phase 14: the reference's scene matrix (``scripts/run_scenes.py``:
    phase-1 reconstruction with NVS, then the phase-2 warm start) on a
    longer clip of phase 7's street, ``tools/mini_clip.py::write_clip`` at
    640x960 and phase 7's density, 21 frames x 3 cameras, the default
    model.  Cuts, depth and scale only: 21 frames where the reference's
    record has 100; windows 0-10 and 11-20 where it uses 0-49 and 50-99;
    phase 9's cadence (40 coarse + 80 fine steps, density control from 20
    every 20, opacity reset every 60), carried in the merged files'
    OptimizationParams where a preset sets its own; ``stage2_nvs``'s
    stride 10 -> 9, since 10 holds nothing out of a 10-frame window (9
    holds out frame 20); 14c runs no final sweep (its path is 14a's).

    (a) ``arguments/nvs.py`` on frames 0-10 (``--end_time 10``, frame 10's
    cameras held out) in this process, phase 7's gates and the sweep's
    test (3 views), train and full splits, the model path
    ``<stage1 root>/<clip>``; (b) ``arguments/static_nvs.py`` likewise:
    the captured step and the sweep without a position head, no
    ``heads.pos`` in the checkpoint, no dx in the logger, no flow graph,
    frames or split PLY; (c) ``stage2.py`` merged (window 11-20,
    ``original_start_time`` 0) with ``--prior_checkpoint`` 14a's final
    checkpoint: the field right after the transplant equals the prior's
    bit for bit, cfg_args hold the window, the first train camera's time
    is frame 11's over [0, 20]; (d) ``stage2_nvs.py`` merged through
    ``python -m s3gaussian_tpu_torch.tools.run_scenes`` in a process of
    its own, first ``--dry_run`` (the command names 14a's checkpoint),
    then for real (``run_summary.json`` ok, the transplant printed, a
    test metrics JSON), then ``scripts/cal.py`` over its output.
    Returns the compositor launches of (a)-(c) by run."""
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.tools.mini_clip import gt_scene, write_clip
    from s3gaussian_tpu_torch.train import checkpoints as ckpt
    from s3gaussian_tpu_torch.train import graphs

    t14 = time.time()
    root = os.path.join(REPO, "build", "chip_smoke_scenes")
    shutil.rmtree(root, ignore_errors=True)
    clip = os.path.join(root, "clips", SCENE_CLIP)
    stage1, stage2 = os.path.join(root, "stage1"), os.path.join(root,
                                                                "stage2")
    t0 = time.time()
    scene = gt_scene(np.random.default_rng(CLIP_SEED), density=CLIP_DENSITY)
    overflow, n_lidar = write_clip(
        clip, scene, SCENE_FRAMES, H, W, np.random.default_rng(CLIP_SEED + 1),
        lidar_cap=CLIP_LIDAR, cfg=RasterConfig(
            max_visible=len(scene["pts"]), rect_w=6, rect_h=6,
            pair_budget=1 << 23), device=dev)
    check(overflow["overflow_visible"] == overflow["overflow_pairs"] == 0,
          f"14: ground-truth renders overflowed their budgets: {overflow}")
    del scene
    print(f"14: clip {SCENE_CLIP}: {SCENE_FRAMES} frames x {CLIP_CAMS} "
          f"cameras {H}x{W} (phase 7's street, density {CLIP_DENSITY}), "
          f"{n_lidar} LiDAR points, written in {time.time() - t0:.2f} s; "
          f"cut from the reference's record: 21 frames of 100, windows 0-10 "
          f"and 11-20 for 0-49 and 50-99, {SCENE_COARSE} coarse + "
          f"{SCENE_FINE} fine steps (density control from "
          f"{CLI_DENSIFY_FROM} every {CLI_DENSIFY_EVERY}, opacity reset "
          f"every {CLI_RESET}), stage2_nvs stride 10 -> {SCENE_NVS_STRIDE}",
          flush=True)

    cadence = ["--seed", str(CLIP_SEED),
               "--densify_from_iter", str(CLI_DENSIFY_FROM),
               "--densification_interval", str(CLI_DENSIFY_EVERY),
               "--opacity_reset_interval", str(CLI_RESET),
               "--checkpoint_iterations", str(CLI_CKPT),
               "--pair_budget", "4194304"]           # bench.py's budget
    phase1 = ["--coarse_iterations", str(SCENE_COARSE), "--iterations",
              str(SCENE_FINE), "--end_time", str(SCENE_STAGE1_END)]
    n1 = (SCENE_STAGE1_END + 1) * CLIP_CAMS
    splits1 = {"test": CLIP_CAMS, "train": n1 - CLIP_CAMS, "full": n1}
    launches = {}

    # (a) nvs on frames 0-10
    out_a = os.path.join(stage1, SCENE_CLIP)
    argv = (["-s", clip, "--model_path", out_a] + cadence + phase1
            + ["--configs", os.path.join(REPO, "arguments", "nvs.py")])
    print(f"14a: train_cli.main({' '.join(argv[4:])})", flush=True)
    state, rec, _, launches["14a nvs"] = scene_run(
        torch, argv, "14a nvs", card, splits=splits1)
    check([int(c.frame_idx) for c in rec["eval_args"][0][1]]
          == [SCENE_STAGE1_END] * CLIP_CAMS,
          "14a: the test split is not frame 10's cameras")
    del state, rec
    torch.cuda.empty_cache()

    # (b) static_nvs on frames 0-10: no position head
    out_b = os.path.join(root, "static_nvs", SCENE_CLIP)
    argv = (["-s", clip, "--model_path", out_b] + cadence + phase1
            + ["--configs", os.path.join(REPO, "arguments",
                                         "static_nvs.py")])
    print(f"14b: train_cli.main({' '.join(argv[4:])})", flush=True)
    state, rec, _, launches["14b static_nvs"] = scene_run(
        torch, argv, "14b static_nvs", card, splits=splits1, dx=False)
    check("pos" not in state.deform.heads, "14b: the field has a pos head")
    flat = torch.load(os.path.join(out_b, f"chkpnt_fine_{SCENE_FINE}",
                                   ckpt.STATE_FILE), weights_only=True)
    check(not any(k.startswith("deform.heads.pos.") for k in flat),
          "14b: heads.pos in the checkpoint")
    check(not any("dx" in k for line in read_logger(
        os.path.join(out_b, "logger.json")) for k in line),
        "14b: a dx entry in the logger")
    written = [f for d in os.listdir(os.path.join(out_b, "eval"))
               if d.endswith(f"_set_{SCENE_FINE}")
               for f in os.listdir(os.path.join(out_b, "eval", d))]
    check(bool(written) and not any("flows" in f for f in written),
          f"14b: flow frames written: {sorted(written)[:4]}")
    check(not os.path.exists(os.path.join(out_b, "eval", "pcd")),
          "14b: a split PLY written")
    del state, rec, flat
    torch.cuda.empty_cache()

    # (c) stage2 merged, in this process, from 14a's checkpoint
    prior = os.path.join(out_a, f"chkpnt_fine_{SCENE_FINE}")
    window = {"start_time": SCENE_WINDOW[0], "end_time": SCENE_WINDOW[1],
              "original_start_time": 0}
    opt = {"coarse_iterations": SCENE_COARSE, "iterations": SCENE_FINE}
    merged2 = merged_preset("stage2.py", os.path.join(root, "stage2.py"),
                            window, opt)
    out_c = os.path.join(root, "stage2_inproc", SCENE_CLIP)
    argv = (["-s", clip, "--model_path", out_c] + cadence
            + ["--configs", merged2, "--prior_checkpoint", prior,
               "--skip_final_eval"])
    moved = []
    orig = ckpt.transplant_deformation

    def transplant(path, st):
        st = orig(path, st)
        got = st.deform.state_dict()
        want = {k[len("deform."):]: v for k, v in torch.load(
            os.path.join(prior, ckpt.STATE_FILE), map_location=dev,
            weights_only=True).items() if k.startswith("deform.")}
        moved.append(got.keys() == want.keys() and all(
            torch.equal(got[k], v) for k, v in want.items()))
        return st

    print(f"14c: train_cli.main({' '.join(argv[4:])}); {merged2}: "
          f"{open(merged2).read().strip()}", flush=True)
    ckpt.transplant_deformation = transplant
    try:
        state, rec, printed, launches["14c stage2"] = scene_run(
            torch, argv, "14c stage2", card)
    finally:
        ckpt.transplant_deformation = orig
    check(moved == [True], f"14c: the field after the transplant is not the "
          f"prior's bit for bit ({moved})")
    check(f"transplanting deformation from {prior}" in printed,
          "14c: no transplant printed")
    with open(os.path.join(out_c, "cfg_args")) as f:
        cfg_args = ast.literal_eval(f.read())
    check(all(cfg_args[k] == v for k, v in window.items())
          and cfg_args["prior_checkpoint"] == prior,
          f"14c: cfg_args window {[cfg_args[k] for k in window]}")
    cam = rec["scene"].get_train_cameras()[0]
    frame = SCENE_WINDOW[0] + int(cam.frame_idx)
    t_want = frame / max(SCENE_WINDOW[1] + 1 - 0 - 1, 1)
    check(int(cam.frame_idx) == 0 and abs(float(cam.time) - t_want) <= 1e-6,
          f"14c: first train camera at frame {frame}, time {float(cam.time)}"
          f", not {t_want}")
    print(f"14c: the field equals 14a's prior bit for bit right after the "
          f"transplant ({len(moved)} transplant); first train camera frame "
          f"{frame} at time {float(cam.time):.6f} = {frame}/"
          f"{SCENE_WINDOW[1]}", flush=True)
    del state, rec, cam
    graphs.release()
    torch.cuda.empty_cache()

    # (d) stage2_nvs through the multi-scene driver, a process of its own
    merged3 = merged_preset(
        "stage2_nvs.py", os.path.join(root, "stage2_nvs.py"),
        dict(window, stride=SCENE_NVS_STRIDE), opt)
    cmd = [sys.executable, "-m", "s3gaussian_tpu_torch.tools.run_scenes",
           "--data_root", os.path.dirname(clip), "--scenes", SCENE_CLIP,
           "--prior_root", stage1, "--configs", merged3, "--output", stage2]
    env = dict(os.environ, S3G_LOG_EVERY=str(CLI_LOG_EVERY),
               S3G_LPIPS_WEIGHTS=LPIPS_FIXTURE)
    dry = run_group(cmd[:3] + ["--dry_run"] + cmd[3:] + ["--"] + cadence,
                    env, 120)
    check(dry.returncode == 0 and f"--prior_checkpoint {prior}" in dry.stdout,
          f"14d: --dry_run rc {dry.returncode}: {dry.stdout[-2000:]}"
          f"{dry.stderr[-2000:]}")
    line = [l for l in dry.stdout.splitlines() if l.startswith("[")][0]
    print(f"14d: {' '.join(cmd[2:])} -- {' '.join(cadence)}; --dry_run: "
          f"{line}", flush=True)
    t0 = time.time()
    run = run_group(cmd + ["--"] + cadence, env, SCENE_TIMEOUT_S)
    run_s = time.time() - t0
    with open(os.path.join(root, "run_scenes.log"), "w") as f:
        f.write(run.stdout + run.stderr)
    check(run.returncode == 0, f"14d: run_scenes exited {run.returncode} "
          f"(killed at {SCENE_TIMEOUT_S} s): "
          f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
    with open(os.path.join(stage2, "run_summary.json")) as f:
        summary = json.load(f)
    check([(s["scene"], s["status"]) for s in summary] == [(SCENE_CLIP, "ok")],
          f"14d: run_summary {summary}")
    check(f"transplanting deformation from {prior}" in run.stdout,
          "14d: no transplant printed")
    out_d = os.path.join(stage2, SCENE_CLIP)
    log = read_logger(os.path.join(out_d, "logger.json"))
    steps = [l for l in log if "Loss" in l]
    check(all(math.isfinite(l["Loss"]) and l["ovf_vis"] == l["ovf_pairs"]
              == l["nan_skips"] == 0 for l in steps)
          and steps[-1]["stage"] == "fine"
          and steps[-1]["step"] == SCENE_FINE,
          f"14d: logged steps {[(l['stage'], l['step']) for l in steps]}")
    mdir = os.path.join(out_d, "eval", "metrics")
    found = {}
    for name in sorted(os.listdir(mdir)):
        step, _, split, _ = name.split("_")
        if step == str(SCENE_FINE):
            with open(os.path.join(mdir, name)) as f:
                found[split] = json.load(f)
    check(set(found) == {"test", "train", "full"} and all(
        math.isfinite(m["psnr"]) and math.isfinite(m["ssim"])
        for m in found.values()), f"14d: sweep metrics {found}")
    test_pngs = os.listdir(os.path.join(out_d, "eval",
                                        f"test_set_{SCENE_FINE}"))
    check(test_pngs and all(f.endswith("_000.png") for f in test_pngs),
          f"14d: test frames {sorted(test_pngs)}")
    cal = run_group([sys.executable, os.path.join(REPO, "scripts", "cal.py"),
                     "--root", stage2, "--split", "test"], None, 120)
    lines = cal.stdout.splitlines()
    check(cal.returncode == 0 and "--- average over 1 scenes (test) ---"
          in lines, f"14d: cal.py rc {cal.returncode}: {cal.stdout}"
          f"{cal.stderr[-2000:]}")
    avg = ast.literal_eval(lines[lines.index(
        "--- average over 1 scenes (test) ---") + 1])
    check(math.isfinite(avg["psnr"]), f"14d: cal.py average {avg}")
    rates = {s: [l for l in steps if l["stage"] == s][-1]["it_per_s"]
             for s in ("coarse", "fine")}
    print(f"14d: run_scenes in {run_s:.2f} s ({SCENE_COARSE} coarse + "
          f"{SCENE_FINE} fine steps and the final sweep in a process of its "
          f"own): it/s coarse {rates['coarse']} fine {rates['fine']}; test "
          f"psnr {found['test']['psnr']:.3f} ssim {found['test']['ssim']:.4f}"
          f" over {CLIP_CAMS} views (frame {SCENE_WINDOW[1]}), train psnr "
          f"{found['train']['psnr']:.3f}; reader s, sweep s per split and "
          f"peak memory: not measured (run_scenes' own process); cal.py: "
          f"{lines[-1]} ({card})", flush=True)
    print(f"14: scene matrix in {time.time() - t14:.1f} s; compositor "
          f"launches " + "; ".join(f"{k} {v[0]} / {v[1]}"
                                   for k, v in launches.items()), flush=True)
    return launches


# per workload of the bench: (timed) launches of one step, forward and
# backward: one a camera
BENCH_LINES = {"detail": 1, "detail_multicam3": 3, "detail_waymo_scale": 1,
               "detail_waymo_rig": 3}
BENCH_TIMEOUT_S = 600


def bench_phase(card):
    """Phase 11: ``python -m s3gaussian_tpu_torch.bench`` in a subprocess
    at its defaults: the headline and the three detail workloads of
    bench.py.  Gates: the headline first and last on stdout, four detail
    lines and no error, no dropped pair, a finite loss, one forward and one
    backward launch a camera of a timed step.  Returns its compositor
    launches and its lines."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "s3gaussian_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    run_s = time.time() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"bench exited {proc.returncode}")
    heads = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    details = {}
    for line in proc.stderr.splitlines():
        if line.startswith("{"):
            details.update(json.loads(line))
    check(len(heads) == 2 and heads[0]["metric"] == heads[1]["metric"]
          == f"train_iters_per_sec_{H}x{W}_fine",
          f"bench: headline lines {heads}")
    check(list(details) == list(BENCH_LINES),
          f"bench: detail lines {list(details)}")
    launches = [0, 0]
    for key, cams in BENCH_LINES.items():
        d = details[key]
        check("error" not in d, f"bench {key}: {d}")
        check(d["overflow_pairs"] == 0 and math.isfinite(d["loss"]),
              f"bench {key}: overflow {d['overflow_pairs']} loss {d['loss']}")
        check(d["launches_per_step"] == [cams, cams],
              f"bench {key}: {d['launches_per_step']} launches a step")
        launches = [a + b for a, b in zip(launches, d["launches"])]
    check(heads[1].get("rig_cams_per_s") == details["detail_waymo_rig"][
        "cams_per_s"], f"bench: last headline {heads[1]}")
    for line in heads[:1] + [{k: v} for k, v in details.items()] + heads[1:]:
        print(f"bench: {json.dumps(line)}", flush=True)
    scale = details["detail_waymo_scale"]
    print(f"bench: {run_s:.1f} s in all; detail_waymo_scale (1.5 M, one "
          f"camera, no cull) peak device memory {scale['peak_gib']} GiB, "
          f"median step {scale['step_ms_median']} ms ({card})", flush=True)
    return tuple(launches), heads + [details]


def dp_world_of_one_phase(torch, dev, card):
    """Phase 12a: NCCL at world size 1 in this process, at the headline:
    one fine ``parallel_train_step`` and one ``train_step`` from one
    mid-training state, held to phase 6's train-step tolerances (the
    per-rank backward is not bit-deterministic); the step's extra cost
    over ``train_step``, the flattening and the all-reduce of its two
    buckets, timed with CUDA events on the step's own terms.  Returns the
    DP step's compositor launches."""
    import torch.distributed as dist

    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.parallel import data_parallel as dp
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost
    from s3gaussian_tpu_torch.train import trainer as tr

    root = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    check(init_multihost("file://" + os.path.join(root, "store_12a"), 1, 0,
                         device="cuda") == (0, 1), "12a: world of one")
    try:
        check(dist.get_backend() == "nccl",
              f"12a: backend {dist.get_backend()}")
        su = headline(torch, dev)
        state = mid_training(torch, tr.init_state(su.pool, su.deform,
                                                  su.aabb), 12)
        start = {k: v.cpu() for k, v in snapshot(torch, state).items()}
        s_one = state_to(torch, state, dev)
        cam = rig_camera(torch, dev, 0.0, 0.4, H, W, su.gt, su.gt_depth)
        args = ("fine", 3, su.hp, su.opt, su.pipe, su.cfg, SPATIAL_LR_SCALE,
                su.bg)
        s_one, aux_one = tr.train_step(s_one, cam, *args)
        tk.reset("composite_fwd", "composite_bwd")
        state, aux = dp.parallel_train_step(state, cam, *args)
        torch.cuda.synchronize()
        launches = tk.compositor_launches()
        check(launches == (1, 1), f"12a: {launches} launches for one camera")
        lg, lc, worst, acc_err = compare_step(
            torch, start, state_to(torch, state, "cpu"),
            state_to(torch, s_one, "cpu"), aux, aux_one, "12a DP step")
        del s_one, aux_one
        # the reduction alone, on a step's terms
        loss, aux2, tree, tap = tr.step_forward(state, [cam], "fine", 3,
                                                su.hp, su.opt, su.pipe,
                                                su.cfg, su.bg)
        grads, tap_grad = tr.step_gradients(loss, tree, tap)
        sums, maxes = dp.step_buckets(
            grads, *tr.rig_stats(tap_grad, aux2), loss.detach(), aux2)
        ms = []
        for _ in range(DP_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            dp.all_reduce_buckets(sums, maxes)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
    finally:
        dist.destroy_process_group()
    print(f"12a: NCCL at world size 1, headline ({N_GAUSSIANS} in "
          f"{CAPACITY}, {H}x{W}, default field), one fine parallel_train_step "
          f"vs train_step from one mid-training state: loss {lg:.6f} vs "
          f"{lc:.6f}, worst update error {worst:.3e} of its tensor's largest "
          f"update, xyz_grad_accum max abs err {acc_err:.3e}; {launches[0]} "
          f"forward / {launches[1]} backward launches", flush=True)
    print(f"12a: the DP step's extra cost over train_step, flattening + "
          f"NCCL all-reduce of its two buckets (CUDA events, median of "
          f"{DP_REPS}): {np.median(ms):.3f} ms (" + " ".join(
              f"{x:.3f}" for x in ms) + f"); SUM bucket {len(sums)} "
          f"tensors, {bucket_bytes(sums)} bytes float32; MAX bucket "
          f"{len(maxes)} tensors, {bucket_bytes(maxes)} bytes int32; "
          f"world size 1: not a scaling figure ({card})", flush=True)
    return launches


def bucket_bytes(terms) -> int:
    """Bytes one all-reduce bucket carries (4 a value: float32 or int32)."""
    return 4 * sum(t.numel() for t in terms.values())


@contextlib.contextmanager
def timed_reductions(torch, rec):
    """Host-clock ms (synchronised) and bytes of every
    ``all_reduce_buckets`` call while it is active, appended to ``rec``."""
    from s3gaussian_tpu_torch.parallel import data_parallel as dp

    orig = dp.all_reduce_buckets

    def timed(sums, maxes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(sums, maxes)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t) * 1e3, bucket_bytes(sums),
                    bucket_bytes(maxes)))
        return out

    dp.all_reduce_buckets = timed
    try:
        yield
    finally:
        dp.all_reduce_buckets = orig


def emulate_dp_step(torch, state, cams, stage, su):
    """One data-parallel step of ``cams`` (one a rank) in one process:
    each camera's gradients from ``step_forward`` / ``step_gradients``,
    averaged, the per-view statistics summed, then ``apply_param_update``
    with the mean loss.  Returns the state and an aux with the loss."""
    from s3gaussian_tpu_torch.train import trainer as tr

    terms = []
    for cam in cams:
        loss, aux, tree, tap = tr.step_forward(state, cam, stage, 3, su.hp,
                                               su.opt, su.pipe, su.cfg, su.bg)
        grads, tap_grad = tr.step_gradients(loss, tree, tap)
        terms.append((loss.detach(), aux, grads, tap_grad))
    n = len(terms)
    grads = {g: {k: sum(t[2][g][k] for t in terms) / n for k in d}
             for g, d in terms[0][2].items()}
    tap_term = sum(torch.linalg.norm(t[3][..., :2], dim=-1) for t in terms)
    vis_count = sum(t[1]["visible"].to(torch.float32) for t in terms)
    loss = sum(t[0] for t in terms) / n
    radii = functools.reduce(torch.maximum, [t[1]["radii"] for t in terms])
    visible = functools.reduce(torch.logical_or,
                               [t[1]["visible"] for t in terms])
    state = tr.apply_param_update(state, grads, tap_term, loss, radii,
                                  visible, su.opt, SPATIAL_LR_SCALE,
                                  vis_count=vis_count)
    return state, {"metrics": {"loss": loss}}


def dp_rank_steps(torch, dev, rank, root):
    """Phase 12b, one rank: the headline (as 12a) from one mid-training
    state, replicated from rank 0; 2 coarse + 3 fine
    ``parallel_train_step``s on this rank's camera, then 3
    ``parallel_train_step_multicam``s on its rig of 3, the replicas'
    checksums compared after every step.  Rank 0 then holds its state
    after the first fine step against ``emulate_dp_step`` of both
    ranks' cameras from the state before it.  Returns the report."""
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.parallel import data_parallel as dp
    from s3gaussian_tpu_torch.parallel.multihost import sync_hosts
    from s3gaussian_tpu_torch.train import trainer as tr

    su = headline(torch, dev)
    state = dp.replicate_state(mid_training(
        torch, tr.init_state(su.pool, su.deform, su.aabb), 12))
    rep = {"agree": [], "step_ms": [], "rig_ms": [], "losses": [],
           "reduce": []}

    def step(fn, state, view, stage, key):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, aux = fn(state, view, stage, 3, su.hp, su.opt, su.pipe,
                        su.cfg, SPATIAL_LR_SCALE, su.bg)
        ev[1].record()
        torch.cuda.synchronize()
        rep[key].append(ev[0].elapsed_time(ev[1]))
        loss = aux["metrics"]["loss"].item()
        rep["losses"].append(loss)
        check(math.isfinite(loss), f"12b rank {rank} {stage}: loss {loss}")
        for k in ("overflow_pairs", "overflow_visible"):
            check(int(aux[k]) == 0, f"12b rank {rank}: {k} {int(aux[k])}")
        lo, hi = dp.replica_checksum_range(state)
        rep["agree"].append(lo == hi)
        return state, aux

    cams = [[rig_camera(torch, dev, yaw, 0.4 + 1e-4 * i, H, W, su.gt,
                        su.gt_depth) for yaw in DP_YAWS]
            for i in range(DP_COARSE + DP_FINE)]
    stages = ["coarse"] * DP_COARSE + ["fine"] * DP_FINE
    tk.reset("composite_fwd", "composite_bwd")
    with timed_reductions(torch, rep["reduce"]):
        for i, stage in enumerate(stages):
            emulated = i == DP_COARSE and rank == 0
            if emulated:
                emul_start = state_to(torch, state, dev)
                start = {k: v.cpu() for k, v in
                         snapshot(torch, emul_start).items()}
            state, aux = step(dp.parallel_train_step, state, cams[i][rank],
                              stage, "step_ms")
            if emulated:
                after, after_aux = state_to(torch, state, "cpu"), aux
        for j in range(DP_RIG_STEPS):
            rig = [rig_camera(torch, dev, yaw, DP_RIG_TIMES[rank] + 1e-4 * j,
                              H, W, su.gt, su.gt_depth) for yaw in YAWS_DEG]
            state, _ = step(dp.parallel_train_step_multicam, state, rig,
                            "fine", "rig_ms")
    torch.cuda.synchronize()
    rep["launches"] = tk.compositor_launches()
    want = DP_COARSE + DP_FINE + DP_RIG_STEPS * len(YAWS_DEG)
    check(rep["launches"] == (want, want),
          f"12b rank {rank}: {rep['launches']} launches, not {want} each")
    check(int(state.nan_skips) == 0, f"12b rank {rank}: nan_skips")
    if rank == 0:
        emul, emul_aux = emulate_dp_step(torch, emul_start, cams[DP_COARSE],
                                         "fine", su)
        rep["emulation"] = compare_step(
            torch, start, after, state_to(torch, emul, "cpu"), after_aux,
            emul_aux, "12b rank 0 vs the single-process emulation")
    sync_hosts("12b")
    return rep


def dp_rank_cli(torch, dev, rank, root):
    """Phase 12c, one rank: ``train_cli.main`` with ``--batch_size 2``
    (the group is up, so its ``init_multihost`` returns it).  Returns the
    report: compositor launches and the final replicas' checksums."""
    from s3gaussian_tpu_torch import train_cli
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.parallel import data_parallel as dp

    with open(os.path.join(root, "argv_12c.json")) as f:
        argv = json.load(f)
    tk.reset("composite_fwd", "composite_bwd")
    t0 = time.time()
    state = train_cli.main(argv)
    torch.cuda.synchronize()
    rep = {"launches": tk.compositor_launches(),
           "s": time.time() - t0, "peak": torch.cuda.max_memory_allocated()}
    rep["checksum"] = dp.replica_checksum_range(state)
    return rep


def dp_rank_main(mode, rank, root) -> int:
    """A rank process of phase 12b (``steps``) or 12c (``cli``): it joins
    the gloo group from ``S3G_COORDINATOR`` / ``S3G_NUM_PROCESSES`` /
    ``S3G_PROCESS_ID`` on the card and writes its report as JSON."""
    import torch
    import torch.distributed as dist

    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost

    rank = int(rank)
    dev = configure_device("cuda")
    check(init_multihost(backend="gloo")
          == (rank, DP_WORLD), "rank: process group")
    try:
        run = dp_rank_steps if mode == "steps" else dp_rank_cli
        rep = run(torch, dev, rank, root)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def run_dp_ranks(mode, root):
    """``DP_WORLD`` rank processes of ``mode`` on the card, meeting at a
    file store under ``root``, each with its log there; fails if one
    exits non-zero or outlasts ``DP_TIMEOUT_S``.  Returns their reports
    and the wall seconds."""
    store = "file://" + os.path.join(root, f"store_{mode}")
    procs, logs = [], []
    t0 = time.time()
    try:
        for r in range(DP_WORLD):
            env = dict(os.environ, S3G_COORDINATOR=store,
                       S3G_NUM_PROCESSES=str(DP_WORLD),
                       S3G_PROCESS_ID=str(r),
                       S3G_LOG_EVERY=str(CLI_LOG_EVERY))
            logs.append(open(os.path.join(root, f"{mode}_rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 mode, str(r), root], cwd=REPO, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.time() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"{mode}_rank{r}.log")) as f:
                print(f.read()[-6000:], file=sys.stderr, flush=True)
        check(p.returncode == 0, f"12 {mode}: rank {r} exited "
              f"{p.returncode} after {wall:.1f} s (killed at "
              f"{DP_TIMEOUT_S} s)")
    reports = []
    for r in range(DP_WORLD):
        with open(os.path.join(root, f"{mode}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports, wall


def dp_two_ranks_phase(card):
    """Phase 12b: two ranks sharing the card over gloo (``dp_rank_steps``).
    Returns the compositor launches of both ranks' DP steps."""
    root = os.path.join(REPO, "build", "chip_smoke_dp")
    reports, wall = run_dp_ranks("steps", root)
    for r, rep in enumerate(reports):
        check(all(rep["agree"]), f"12b: replica checksums differ after "
              f"steps {[i for i, a in enumerate(rep['agree']) if not a]}")
    check(reports[0]["losses"] == reports[1]["losses"],
          "12b: the ranks' reduced losses differ")
    lg, lc, worst, acc_err = reports[0]["emulation"]
    print(f"12b: {DP_WORLD} gloo ranks on the card (CUDA tensors staged "
          f"through the host), headline, cameras yawed {DP_YAWS}: "
          f"{DP_COARSE} coarse + {DP_FINE} fine parallel_train_steps and "
          f"{DP_RIG_STEPS} parallel_train_step_multicam on a rig of "
          f"{len(YAWS_DEG)} a rank, replica checksums equal after all "
          f"{len(reports[0]['agree'])} steps; rank 0 after the first fine "
          f"step vs the single-process emulation: loss {lg:.6f} vs "
          f"{lc:.6f}, worst update error {worst:.3e}, xyz_grad_accum max "
          f"abs err {acc_err:.3e}; launches per rank "
          f"{[tuple(r['launches']) for r in reports]}; {wall:.1f} s wall",
          flush=True)
    for r, rep in enumerate(reports):
        red = rep["reduce"]
        print(f"12b rank {r}: step ms (CUDA events) " + " ".join(
            f"{x:.2f}" for x in rep["step_ms"]) + " | rig step ms "
            + " ".join(f"{x:.2f}" for x in rep["rig_ms"])
            + f"; all-reduce ms (host clock, synchronised, median of "
            f"{len(red)}) {np.median([x[0] for x in red]):.2f}, bytes a "
            f"step SUM {red[0][1]} (single) / {red[-1][1]} (rig), MAX "
            f"{red[0][2]} ({DP_LABEL}; {card})", flush=True)
    return tuple(sum(rep["launches"][i] for rep in reports) for i in (0, 1))


def dp_cli_phase(clip, card):
    """Phase 12c: ``train_cli.main`` with ``--batch_size 2`` on two gloo
    ranks on phase 7's clip, depth cut to 20 coarse + 40 fine, density
    control from step 10 every 20 (a densify under DP in each stage), no
    sweep; one model path.  Gates: every logged loss finite, one logger
    line a logged step (only rank 0 writes), no visible or pair overflow,
    the densifies, one final checkpoint and one PLY, the replicas equal
    at the end, one forward and one backward launch a step a rank.
    Returns the compositor launches of both ranks."""
    from s3gaussian_tpu_torch.utils.ply import read_ply

    root = os.path.join(REPO, "build", "chip_smoke_dp")
    out = os.path.join(root, "cli")
    argv = ["-s", clip, "--model_path", out, "--seed", str(CLIP_SEED),
            "--coarse_iterations", str(DP_CLI_COARSE),
            "--iterations", str(DP_CLI_FINE),
            "--densify_from_iter", str(DP_CLI_DENSIFY_FROM),
            "--densification_interval", str(CLI_DENSIFY_EVERY),
            "--opacity_reset_interval", str(CLI_RESET),
            "--checkpoint_iterations", str(CLI_CKPT),
            "--pair_budget", "4194304", "--batch_size", str(DP_WORLD),
            "--skip_final_eval", "--steps_per_dispatch", "1"]
    with open(os.path.join(root, "argv_12c.json"), "w") as f:
        json.dump(argv, f)
    reports, wall = run_dp_ranks("cli", root)
    log = read_logger(os.path.join(out, "logger.json"))
    steps = [l for l in log if "Loss" in l]
    for l in steps:
        where = f"12c {l['stage']} step {l['step']}"
        check(math.isfinite(l["Loss"]), f"{where}: Loss {l['Loss']}")
        check(l["ovf_vis"] == l["ovf_pairs"] == 0,
              f"{where}: overflow visible {l['ovf_vis']} pairs "
              f"{l['ovf_pairs']}")
        check(l["nan_skips"] == 0, f"{where}: nan_skips {l['nan_skips']}")
    want_steps = [(stage, i) for stage, n in (("coarse", DP_CLI_COARSE),
                                              ("fine", DP_CLI_FINE))
                  for i in [1] + list(range(CLI_LOG_EVERY, n + 1,
                                            CLI_LOG_EVERY))]
    check([(l["stage"], l["step"]) for l in steps] == want_steps,
          f"12c: logged steps {[(l['stage'], l['step']) for l in steps]} "
          f"(one line a logged step, rank 0 alone)")
    dens = [(l["stage"], l["step"]) for l in log if "densify" in l]
    check(dens == [(stage, i) for stage, n in (("coarse", DP_CLI_COARSE),
                                               ("fine", DP_CLI_FINE))
                   for i in range(DP_CLI_DENSIFY_FROM + 1, n + 1)
                   if i % CLI_DENSIFY_EVERY == 0],
          f"12c: densifies at {dens}")
    check(sorted(d for d in os.listdir(out) if d.startswith("chkpnt_"))
          == [f"chkpnt_fine_{DP_CLI_FINE}"], "12c: checkpoints")
    plys = os.listdir(os.path.join(out, "point_cloud"))
    check(plys == [f"iteration_{DP_CLI_FINE}"], f"12c: PLYs {plys}")
    n_ply = len(read_ply(os.path.join(out, "point_cloud", plys[0],
                                      "point_cloud.ply"))["x"])
    sums = [rep["checksum"] for rep in reports]
    check(all(lo == hi for lo, hi in sums) and sums[0] == sums[1],
          f"12c: final replica checksums {sums}")
    want = DP_CLI_COARSE + DP_CLI_FINE
    for r, rep in enumerate(reports):
        check(tuple(rep["launches"]) == (want, want),
              f"12c rank {r}: {rep['launches']} launches for {want} steps")
    rates = {s: [l for l in steps if l["stage"] == s][-1]["it_per_s"]
             for s in ("coarse", "fine")}
    print(f"12c: train_cli.main({' '.join(argv[4:])}) on phase 7's clip, "
          f"{DP_WORLD} gloo ranks, one model path: {len(steps)} logged "
          f"steps, densifies at {dens}, {n_ply} Gaussians in the PLY, "
          f"final replica checksums equal; it/s coarse {rates['coarse']} "
          f"fine {rates['fine']} (rank 0's logger); rank seconds "
          + " ".join(f"{rep['s']:.1f}" for rep in reports)
          + f", peak " + " ".join(f"{rep['peak'] / 2 ** 30:.2f}"
                                  for rep in reports)
          + f" GiB; {wall:.1f} s wall ({DP_LABEL}; {card})", flush=True)
    return tuple(sum(rep["launches"][i] for rep in reports) for i in (0, 1))


def profile_counts(torch, fn, n_steps):
    """(device operations, host launch calls, device ms, (``span_mark``
    kernels, their device ms)) a step of what ``fn`` runs, as
    ``torch.profiler`` counts them: the kernels, copies and fills the
    card ran, and the runtime calls that launched them (a graph replay is
    one ``cudaGraphLaunch``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = [e for e in events if e.name in LAUNCH_CALLS]
    marks = [e for e in device if e.name == "span_mark"]
    return (len(device) / n_steps, len(calls) / n_steps,
            sum(e.device_time_total for e in device) / 1e3 / n_steps,
            (len(marks) / n_steps,
             sum(e.device_time_total for e in marks) / 1e3 / n_steps))


def compare_blocks(torch, start, s_graph, s_eager, aux_g, aux_e, what):
    """A block of replayed steps against as many eager ones from the same
    state, within phase 6's step tolerances: every step's metrics rtol
    STEP_LOSS_RTOL, its counters equal but for 0.1%, its largest visible
    radius within a pixel; the last state by ``compare_step``; the Adam
    moments atol STEP_ATOL_SCALE·max rtol STEP_RTOL; count, step and
    nan_skips equal."""
    for k, e in aux_e["metrics"].items():
        e, g = e.double().cpu(), aux_g["metrics"][k].double().cpu()
        check(bool(((g - e).abs() <= STEP_LOSS_RTOL * e.abs() + 1e-9).all()),
              f"{what} metric {k}: replayed {g.tolist()} eager {e.tolist()}")
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs", "n_r20"):
        e, g = aux_e[k].cpu().long(), aux_g[k].cpu().long()
        check(bool(((g - e).abs() <= torch.clamp(e // 1000, min=1)).all()),
              f"{what} {k}: replayed {g.tolist()} eager {e.tolist()}")
    check(bool(((aux_g["radii_max"] - aux_e["radii_max"]).abs() <= 1).all()),
          f"{what} radii_max: {aux_g['radii_max'].tolist()} vs "
          f"{aux_e['radii_max'].tolist()}")
    last = [{"metrics": {"loss": a["metrics"]["loss"][-1]}}
            for a in (aux_g, aux_e)]
    e_cpu = state_to(torch, s_eager, "cpu")
    _, _, worst, acc_err = compare_step(torch, start, s_graph, e_cpu,
                                        *last, what)
    for which in ("mu", "nu"):
        for g, d in getattr(e_cpu.adam, which).items():
            for k, e in d.items():
                got = getattr(s_graph.adam, which)[g][k].cpu()
                err = (got - e).abs()
                bad = err > STEP_ATOL_SCALE * float(e.abs().max()) \
                    + STEP_RTOL * e.abs()
                check(not bool(bad.any()), f"{what} adam {which} {g}.{k}: "
                      f"{int(bad.sum())} entries differ, max "
                      f"{float(err.max()):.3e}")
    for name, a, b in (("count", s_graph.adam.count, e_cpu.adam.count),
                       ("step", s_graph.step, e_cpu.step),
                       ("nan_skips", s_graph.nan_skips, e_cpu.nan_skips)):
        check(int(a) == int(b), f"{what} {name}: {int(a)} vs {int(b)}")
    return worst, acc_err


# phase 13e: kernels whose names mark an accumulation with atomics in a
# step's backward, none of which may remain; kernels printed a profile
ATOMIC_KERNELS = ("indexing_backward_kernel", "indexFuncLargeIndex")
TOP_KERNELS = 8


def kernel_table(torch, fn):
    """{kernel name: (launches, device ms)} of what ``fn`` runs on the
    card, as ``torch.profiler`` records it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = table.get(e.name, (0, 0.0))
            table[e.name] = (n + 1, ms + e.device_time_total / 1e3)
    return table


def repeat_step(torch, state, step, view, args, what, card):
    """Phase 13e: two eager steps of ``step`` on ``view`` from copies of
    ``state`` must give the same bits: loss, parameters, Adam moments and
    count, the densification statistics.  Then one step profiled (no
    kernel of ATOMIC_KERNELS; the backward's largest kernels printed) and
    one step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, a diagnostic: the operations PyTorch warns about
    are printed."""
    import warnings

    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors

    dev = state.pool.xyz.device
    runs = []
    for _ in range(2):
        st, aux = step(state_to(torch, state, dev), view, *args)
        torch.cuda.synchronize()
        runs.append((state_tensors(st), aux["metrics"]["loss"].clone()))
        del st, aux
    (t1, l1), (t2, l2) = runs
    differ = [(k, int((v != t2[k]).sum())) for k, v in t1.items()
              if not torch.equal(v, t2[k])]
    check(torch.equal(l1, l2) and not differ,
          f"13e {what}: two steps from one state differ: loss "
          f"{l1.item()!r} / {l2.item()!r}, tensors (name, entries) "
          f"{differ[:6]}")
    del runs, t1, t2
    st = state_to(torch, state, dev)
    whole = kernel_table(torch, lambda: step(st, view, *args))
    found = [k for k in whole if any(a in k for a in ATOMIC_KERNELS)]
    check(not found, f"13e {what}: a step launches {found}")
    st = state_to(torch, state, dev)
    stage, sh, hp, opt, pipe, cfg, _, bg = args
    loss, _, tree, tap = tr.step_forward(st, view, stage, sh, hp, opt, pipe,
                                         cfg, bg)
    bwd = kernel_table(torch, lambda: tr.step_gradients(loss, tree, tap))
    del loss, tree, tap
    st = state_to(torch, state, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(st, view, *args)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have a "
                                           "deterministic")[0][:80]
                      for w in caught if "determinis" in str(w.message)})
    del st
    top = sorted(bwd.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    print(f"13e {what}: two eager steps from one state bit-identical (loss "
          f"{l1.item():.6f}, every parameter, moment and statistic); step "
          f"profile: {sum(n for n, _ in whole.values())} kernels, "
          f"{sum(ms for _, ms in whole.values()):.3f} device ms, none of "
          f"{ATOMIC_KERNELS}; the backward's largest kernels (launches, "
          f"device ms): " + "; ".join(
              f"{k[:60]} ({n}, {ms:.3f})" for k, (n, ms) in top)
          + f"; deterministic mode (diagnostic) flags: "
          f"{flagged or 'nothing'} ({card})", flush=True)


def graph_phase(torch, su, state, card):
    """Phase 13: the train step captured as one CUDA graph against the
    eager step on the card, from ``state`` (5b's pool, field and
    moments), cameras
    that differ in yaw, time, field of view and target: (a) a fine block
    of GRAPH_BLOCK through ``train_steps_scan``, (b) GRAPH_RIGS rigs of 3
    through ``train_steps_scan_multicam``, (c) a ``densify_step`` between
    two blocks of GRAPH_SPLIT, the second loaded into the held graph,
    (d) a block of GRAPH_DP ``parallel_train_steps_scan`` under NCCL at
    world size 1 against ``train_steps_scan``.  Each held to
    ``compare_blocks``; the second eager step of each kind runs with
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in a step).
    Prints per block the capture ms, ms a step replayed and eager (CUDA
    events, median), device operations and host launch calls a step as
    the profiler counts them, and the peak memory of either.  The stage
    marks of (a) and (b) (``utils/spans.py``): the graph captured one
    ``span_mark`` launch a mark of the step's sequence, the replays and
    the warm-up step launched them again, a profile of the replays holds
    as many ``span_mark`` kernels, and the replayed steps' spans sum to
    within SPAN_COVER of their CUDA-event time.  Returns the compositor
    launches of the replays and (``span_mark`` kernels, their device ms)
    a step of the profiled replays of (a) and (b)."""
    import torch.distributed as dist

    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.parallel import data_parallel as dp
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors
    from s3gaussian_tpu_torch.utils import spans

    dev = su.bg.device
    args = ("fine", 3, su.hp, su.opt, su.pipe, su.cfg, SPATIAL_LR_SCALE,
            su.bg)
    targets = [(su.gt, su.gt_depth),
               (np.ascontiguousarray(su.gt[::-1]),
                np.ascontiguousarray(su.gt_depth[::-1]))]

    def cam(i, yaw):
        img, dmap = targets[i % 2]
        return rig_camera(torch, dev, yaw, 0.4 + 1e-3 * i, H, W, img, dmap,
                          fov=GRAPH_FOVS[i % len(GRAPH_FOVS)])

    singles = [cam(i, YAWS_DEG[i % 3]) for i in range(GRAPH_BLOCK)]
    rigs = [[cam(i, yaw) for yaw in YAWS_DEG] for i in range(GRAPH_RIGS)]
    # 5b's pool, field and Adam moments: the step is deterministic, so
    # rows whose second moment is near 0 (moved by the sign of a
    # gradient) move alike in both
    base = state_to(torch, state, dev)
    l13 = tk.compositor_launches()

    def eager(st, views, step, sync_check):
        ms, rows = [], []
        for i, v in enumerate(views):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            no_sync = sync_check and i == 1
            if no_sync:
                # any host sync inside the step raises (the first step
                # fills the constant caches)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                ev[0].record()
                st, aux = step(st, v, *args)
                ev[1].record()
                rows.append(tr.small_aux(aux))
            finally:
                if no_sync:
                    torch.cuda.set_sync_debug_mode("default")
            ms.append(ev)
        torch.cuda.synchronize()
        return st, tr.stack_aux(rows), [a.elapsed_time(b) for a, b in ms]

    def replayed(st, views, scan, n_cams):
        marks = []
        l0 = dict(tk.launches)
        extra = (n_cams,) if n_cams else ()
        st, aux = scan(st, views, *extra, *args, marks=marks)
        torch.cuda.synchronize()
        got = {k: n - l0[k] for k, n in tk.launches.items()}
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return st, aux, ms, got

    def measured(run):
        graphs.release()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = run()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - held) / 2 ** 30, \
            torch.cuda.memory_reserved() / 2 ** 30

    def block_case(what, views, step, scan, n_cams):
        b = max(n_cams, 1)
        start = {k: v.cpu() for k, v in snapshot(torch, base).items()}
        (s_e, aux_e, ms_e), peak_e, res_e = measured(
            lambda: eager(state_to(torch, base, dev), views, step, True))
        (s_g, aux_g, ms_g, got), peak_g, res_g = measured(
            lambda: replayed(state_to(torch, base, dev), views, scan, n_cams))
        g = graphs.current()
        n = len(views)
        # the capture's mark sequence: its spans, the closing mark and the
        # field's inner spans
        n_marks = len(spans.last_marks()) + 1 + len(spans.last_inner())
        cap = g.captured
        check(tk.compositor_launches(cap) == (b, b),
              f"{what}: the graph captured {tk.compositor_launches(cap)} "
              f"launches for {b} camera(s)")
        check(tk.compositor_launches(got) == ((n + 1) * b,) * 2,
              f"{what}: {tk.compositor_launches(got)} launches for {n} "
              f"replays and the capture's warm-up step of {b} camera(s)")
        # a step's marks; one field evaluation a step: a forward and a
        # backward a scale
        for kernel, want in (("span_mark", n_marks), ("hexplane_fwd", 1),
                             ("hexplane_bwd", len(su.hp.multires))):
            check(cap[kernel] == want and got[kernel] == (n + 1) * want,
                  f"{what}: {cap[kernel]} {kernel} launches captured and "
                  f"{got[kernel]} launched for {n} replays and a warm-up "
                  f"step of {want}")
        span_ms = aux_g["span_ns"].double().sum(1).cpu() / 1e6
        cover = float(span_ms.sum()) / sum(ms_g)
        check(abs(cover - 1.0) <= SPAN_COVER,
              f"{what}: the replayed steps' spans sum to "
              f"{float(span_ms.sum()):.3f} ms, their CUDA-event time is "
              f"{sum(ms_g):.3f} ms")
        worst, acc_err = compare_blocks(torch, start, s_g, s_e, aux_g, aux_e,
                                        what)
        prof_views = views[:GRAPH_PROFILE]
        dev_e, calls_e, kms_e, _ = profile_counts(
            torch, lambda: eager(s_e, prof_views, step, False),
            GRAPH_PROFILE)
        dev_g, calls_g, kms_g, (marks_g, mark_ms) = profile_counts(
            torch, lambda: replayed(s_g, prof_views, scan, n_cams),
            GRAPH_PROFILE)
        check(marks_g == n_marks, f"{what}: {marks_g} span_mark kernels "
              f"a replayed step in the profile, the sequence has {n_marks}")
        mark_stats.append((marks_g, mark_ms))
        med_e, med_g = float(np.median(ms_e)), float(np.median(ms_g))
        print(f"13 {what}: {n} steps of {b} camera(s), replayed vs eager "
              f"from one mid-training state: worst update error "
              f"{worst:.3e} of its tensor's largest update, xyz_grad_accum "
              f"max abs err {acc_err:.3e}, losses " + " ".join(
                  f"{x:.6f}" for x in aux_g["metrics"]["loss"].tolist())
              + f"; warm-up {g.warmup_ms:.1f} ms, capture {g.capture_ms:.1f}"
              f" ms; ms a step (CUDA events, median) replayed {med_g:.3f} "
              f"eager {med_e:.3f} (" + " ".join(f"{x:.2f}" for x in ms_g)
              + " | " + " ".join(f"{x:.2f}" for x in ms_e) + "); a step, "
              f"profiled over {GRAPH_PROFILE}: device operations "
              f"{dev_g:.0f} replayed / {dev_e:.0f} eager, host launch calls "
              f"{calls_g:.0f} / {calls_e:.0f}, device ms {kms_g:.3f} / "
              f"{kms_e:.3f} (busy share {kms_g / med_g:.3f} / "
              f"{kms_e / med_e:.3f}); peak above the states "
              f"{peak_g:.2f} GiB replayed (warm-up and capture included) / "
              f"{peak_e:.2f} eager, reserved after {res_g:.2f} / "
              f"{res_e:.2f} GiB; {cap['composite_fwd']} forward / "
              f"{cap['composite_bwd']} backward launches a replay, "
              f"{cap['hexplane_fwd']} + {cap['hexplane_bwd']} hexplane "
              f"launches; {n_marks} span marks a step, "
              f"{mark_ms:.4f} device ms a step in {marks_g:.0f} span_mark "
              f"kernels, the spans' sum {cover:.4f} of the CUDA-event time "
              f"({card})", flush=True)
        del s_e, aux_e
        return s_g

    t13 = time.time()
    mark_stats = []
    block_case("(a) fine block", singles, tr.train_step, tr.train_steps_scan,
               0)
    block_case("(b) rig block", rigs, tr.train_step_multicam,
               tr.train_steps_scan_multicam, 3)

    # (c) a densify between two blocks: the second block loads the
    # densified state into the held graph, no recapture.  It starts from
    # mid-training moments, which move enough opacities under the prune
    # threshold in a block for the densify to prune (5b's do not)
    graphs.release()
    s_g, _ = tr.train_steps_scan(
        mid_training(torch, state_to(torch, base, dev), 13),
        singles[:GRAPH_SPLIT], *args)
    g = graphs.current()
    statics = {k: v.data_ptr()
               for k, v in state_tensors(s_g).items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    noise = torch.randn((2, CAPACITY, 3), generator=gen, device=dev)
    d_state, info = tr.densify_step(
        s_g, gen, su.opt.densify_grad_threshold_fine_init, 0.005, 50.0, None,
        su.opt, noise=noise)
    info = {k: int(v) for k, v in info.items()}
    check(info["n_cloned"] + info["n_split"] > 0 and info["n_pruned"] > 0,
          f"13 (c): densify {info}")
    s_e = state_to(torch, d_state, dev)
    start = {k: v.cpu() for k, v in snapshot(torch, d_state).items()}
    l0 = tk.compositor_launches()
    s_g2, aux_g = tr.train_steps_scan(d_state, singles[GRAPH_SPLIT:
                                                       2 * GRAPH_SPLIT],
                                      *args)
    torch.cuda.synchronize()
    check(graphs.current() is g and s_g2 is g.state,
          "13 (c): the block after the densify captured anew")
    check({k: v.data_ptr() for k, v in state_tensors(s_g2).items()}
          == statics, "13 (c): the static state moved")
    got = comp_since(l0)
    check(got == (GRAPH_SPLIT,) * 2, f"13 (c): {got} launches for "
          f"{GRAPH_SPLIT} replays")
    s_e, aux_e, _ = eager(s_e, singles[GRAPH_SPLIT:2 * GRAPH_SPLIT],
                          tr.train_step, False)
    worst, acc_err = compare_blocks(torch, start, s_g2, s_e, aux_g, aux_e,
                                    "13 (c) after densify")
    print(f"13 (c): block of {GRAPH_SPLIT}, densify_step ("
          + ", ".join(f"{k} {v}" for k, v in info.items() if k.startswith(
              "n_")) + f"), block of {GRAPH_SPLIT} loaded into the held "
          f"graph (no recapture, the static tensors in place) vs "
          f"{GRAPH_SPLIT} eager steps from the densified state: worst "
          f"update error {worst:.3e}, xyz_grad_accum max abs err "
          f"{acc_err:.3e}", flush=True)
    del s_g, s_g2, s_e, d_state, noise

    # (d) the data-parallel block under NCCL at world size 1
    graphs.release()
    root = os.path.join(REPO, "build", "chip_smoke_graph")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    check(init_multihost("file://" + os.path.join(root, "store"), 1, 0,
                         device="cuda") == (0, 1), "13 (d): world of one")
    try:
        check(dist.get_backend() == "nccl",
              f"13 (d): backend {dist.get_backend()}")
        eager(state_to(torch, base, dev), singles[:2], dp.parallel_train_step,
              True)
        views = singles[:GRAPH_DP]
        start = {k: v.cpu() for k, v in snapshot(torch, base).items()}
        (s_one, aux_one, ms_one, _), _, _ = measured(lambda: replayed(
            state_to(torch, base, dev), views, tr.train_steps_scan, 0))
        (s_dp, aux_dp, ms_dp, got), peak_dp, _ = measured(lambda: replayed(
            state_to(torch, base, dev), views, dp.parallel_train_steps_scan,
            0))
        got = tk.compositor_launches(got)
        check(got == (GRAPH_DP + 1,) * 2,
              f"13 (d): {got} launches for {GRAPH_DP} replays and a "
              f"warm-up")
        g = graphs.current()
        graphs.release()
        worst, acc_err = compare_blocks(torch, start, s_dp, s_one, aux_dp,
                                        aux_one, "13 (d) DP block")
    finally:
        graphs.release()
        dist.destroy_process_group()
    print(f"13 (d): NCCL at world size 1, a block of {GRAPH_DP} "
          f"parallel_train_steps_scan (both all-reduces captured) vs "
          f"train_steps_scan from one state: worst update error "
          f"{worst:.3e}, xyz_grad_accum max abs err {acc_err:.3e}; capture "
          f"{g.capture_ms:.1f} ms; ms a step (CUDA events, median) DP "
          f"{np.median(ms_dp):.3f} vs {np.median(ms_one):.3f}; peak above "
          f"the states {peak_dp:.2f} GiB ({card})", flush=True)
    launches = comp_since(l13)

    # (e) two eager steps from one state give the same bits: the single
    # camera, and 5b's rig with two-class emission (6c runs the Waymo rig)
    repeat_step(torch, base, tr.train_step, singles[0], args,
                "headline camera", card)
    two_class = dataclasses.replace(su.cfg, big_budget=REPEAT_BIG_BUDGET)
    repeat_step(torch, base, tr.train_step_multicam, rigs[0],
                args[:5] + (two_class,) + args[6:],
                f"rig of 3, two-class (big_budget {REPEAT_BIG_BUDGET})",
                card)
    print(f"13: graph vs eager in {time.time() - t13:.1f} s; "
          f"{launches[0]} forward / {launches[1]} backward launches",
          flush=True)
    return launches, tuple(sum(x) for x in zip(*mark_stats))


T_START = time.time()


def main(only=None) -> int:
    """The smoke run; ``only="13"`` runs the build and phase 13 alone (on
    a fresh headline state with mid-training moments), ``only="14"`` the
    build and phase 14 alone, ``only="15"`` the build and phases 7, 8 and
    15; none prints a result line."""
    import torch

    from s3gaussian_tpu_torch.bench import card_line
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

    if only == "14":
        scene_matrix_phase(torch, dev, card)
        print("chip_smoke: phase 14 alone, not the smoke run", flush=True)
        return 0
    if only == "15":
        _, argv, out, _, (per_view7, _) = cli_phase(torch, dev, card)
        _, rec8 = eval_only_phase(torch, argv, out, per_view7, card)
        exchange_phase(torch, dev, argv, out, rec8, card)
        print("chip_smoke: phases 7, 8 and 15 alone, not the smoke run",
              flush=True)
        return 0
    # the headline workload of bench.py
    t0 = time.time()
    su = headline(torch, dev)
    if only == "13":
        graph_phase(torch, su, mid_training(
            torch, tr.init_state(su.pool, su.deform, su.aabb), 13), card)
        print("chip_smoke: phase 13 alone, not the smoke run", flush=True)
        return 0
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

    # 3b. the segment-sum kernel vs plain on a step's calls
    seg = segsum_phase(torch, su, card)
    # 3c. the hexplane kernels vs plain at the benchmark's pool size
    hexk = hexplane_phase(torch, su, card)

    # 4. the render path through the user entry points, launches counted
    # (the segment-sum launches from here on, but for the comparisons of
    # phase 6)
    rasterize_calls = 0
    frame_ms = []
    renders = []
    tk.reset()
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
    # renders a camera, replays of two graphs, each capture's warm-up
    # render launching once more
    stats4 = {}
    frames = render_pixels(cams, pool, deform, pipe, bg, aabb, 3, "fine", cfg,
                           compute_metrics=False, return_decomposition=True,
                           stats=stats4)
    rasterize_calls += 5 * len(cams) + sum(c[3][0]
                                           for c in stats4["captures"])
    torch.cuda.synchronize()
    render_launches = tk.compositor_launches()
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
    tk.reset("composite_fwd", "composite_bwd")
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
    train_launches = tk.compositor_launches()
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
        loss, aux, tree, tap = tr.step_forward(state, [cam], "fine", 3, hp,
                                               opt, pipe, cfg, bg)
        ev[1].record()
        grads, tap_grad = tr.step_gradients(loss, tree, tap)
        ev[2].record()
        state = tr.rig_update(state, grads, tap_grad, loss.detach(), aux,
                              tr.unscaled(opt), SPATIAL_LR_SCALE)
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

    # 13. the train step as a captured CUDA graph against the eager step,
    # from 5b's mid-training state
    graph13, marks13 = graph_phase(torch, su, state, card)
    del state

    seg_compare = tk.launches["segment_sum"]
    mark_compare = tk.launches["span_mark"]
    hex_compare = {k: tk.launches[k] for k in HEX_KERNELS}
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

    seg_compare = tk.launches["segment_sum"] - seg_compare
    mark_compare = tk.launches["span_mark"] - mark_compare
    hex_compare = {k: tk.launches[k] - n for k, n in hex_compare.items()}
    del su, pool, deform, cams, small_pool, cpu_pool, s_gpu, s_cpu
    torch.cuda.empty_cache()

    # 6c. the Waymo rig at full width: 1.5 M points, cull, two-class
    waymo_launches = waymo_rig_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # 7. the training CLI, this slice's main path; launches counted over it
    _, argv, out, rec7, (per_view7, sweep7) = cli_phase(torch, dev, card)
    # 7b. the sweep's replays against direct renders of phase 7's model
    sweep7b = sweep_graph_phase(torch, rec7, card)
    rec7["eval_args"] = None
    metrics_on_card(torch, rec7, card)
    train7 = rec7["train_launches"]

    # 8. --eval_only on phase 7's model path
    sweep8, rec8 = eval_only_phase(torch, argv, out, per_view7, card)

    # 9. the waymo_perf preset through the CLI on phase 7's clip
    train9, sweep9 = perf_cli_phase(torch, argv, card)

    # 10. the offline tools on phase 7's model path
    tools10 = tools_phase(torch, out, rec7, card)
    del rec7
    torch.cuda.empty_cache()

    # 15. checkpoint interchange: phase 7's state across and back, and a
    # scene the JAX package trained, on the card
    exchange15 = exchange_phase(torch, dev, argv, out, rec8, card)
    del rec8
    torch.cuda.empty_cache()

    # 14. the scene matrix: nvs, static_nvs and stage2 through the CLI in
    # this process, stage2_nvs through the multi-scene driver
    scenes14 = scene_matrix_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # 11. the bench, in a process of its own
    bench11, _ = bench_phase(card)

    # 12. data parallelism: NCCL at world size 1 here, then two gloo
    # ranks sharing the card at the headline and through the CLI
    t12 = time.time()
    dp12a = dp_world_of_one_phase(torch, dev, card)
    torch.cuda.empty_cache()
    dp12b = dp_two_ranks_phase(card)
    dp12c = dp_cli_phase(argv[1], card)
    print(f"12: data parallelism in {time.time() - t12:.1f} s", flush=True)
    path = {"4 render path": render_launches, "5 training slice":
            train_launches, "5b rig step": rig_launches,
            "6c waymo rig": waymo_launches, "7 CLI training": train7,
            "7 final sweep": sweep7, "7b replayed sweep": sweep7b,
            "8 --eval_only sweep": sweep8,
            "9 waymo_perf training": train9, "9 waymo_perf sweep": sweep9,
            "10 offline tools": tools10, "11 bench": bench11,
            "12a NCCL world 1": dp12a, "12b two gloo ranks": dp12b,
            "12c CLI two gloo ranks": dp12c, "13 graph vs eager": graph13,
            **scenes14, **exchange15}
    main_launches = tuple(sum(v[i] for v in path.values()) for i in (0, 1))
    print("compositor launches, forward / backward: " + "; ".join(
        f"{k} {v[0]} / {v[1]}" for k, v in path.items())
        + f"; total {main_launches[0]} / {main_launches[1]}", flush=True)
    check(rig_launches[0] > 0 and waymo_launches[0] > 0 and train9[0] > 0,
          "a rig phase launched no kernel")
    check(tools10[0] > 0 and bench11[0] > 0 and bench11[1] > 0,
          "the tools or the bench launched no kernel")
    check(all(v[0] > 0 and v[1] > 0 for v in (dp12a, dp12b, dp12c)),
          "a data-parallel phase launched no kernel")
    check(graph13[0] > 0 and graph13[1] > 0, "phase 13 launched no kernel")
    check(all(v[0] > 0 and v[1] > 0 for v in scenes14.values()),
          "a run of phase 14 launched no kernel")
    check(all(v[0] > 0 and (v[1] > 0 or "eval_only" in k)
              for k, v in exchange15.items()),
          "a run of phase 15 launched no kernel")
    # this process's segment sums over the path (the bench's and the rank
    # processes' are not counted here)
    seg_main = tk.launches["segment_sum"] - seg_compare
    check(seg_main > 0, "the path launched no segment-sum kernel")
    mark_main = tk.launches["span_mark"] - mark_compare
    check(mark_main > 0, "the path launched no span-mark kernel")
    hex_main = {k: tk.launches[k] - n for k, n in hex_compare.items()}
    check(all(hex_main.values()), f"the path's hexplane launches "
          f"{hex_main}: a kernel never launched")
    print(f"segment-sum launches over this process's phases of the path: "
          f"{seg_main}; span-mark launches: {mark_main}; hexplane launches: "
          f"forward {hex_main['hexplane_fwd']}, backward "
          f"{hex_main['hexplane_bwd']}", flush=True)
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
    kernels.append({
        "name": "segment_sum",
        "route": "cuda",
        "source": "s3gaussian_tpu_torch/csrc/segment_sum.cu",
        # no Pallas kernel: the time rows' VJP (a one-hot product) and the
        # autodiff scatter-adds that XLA runs for the field's gradients
        "replaces": "s3gaussian_tpu/ops/gridsample.py:143",
        "launches": seg_main,
        "max_abs_err": seg["max_err"],
        "ms": seg["ms"],
        "plain_ms": seg["plain_ms"],
        "bound_ms": seg["bound"][0],
        "bound_by": seg["bound"][1],
        "library_ms": seg["library_ms"],
    })
    kernels.append({
        "name": "span_mark",
        "route": "cuda",
        "source": "s3gaussian_tpu_torch/csrc/span_mark.cu",
        # no Pallas kernel: the train step's stage marks (utils/spans.py)
        "replaces": None,
        "launches": mark_main,
        "max_abs_err": None,
        # a launch's device time in phase 13's profiles of replayed steps
        "ms": marks13[1] / marks13[0],
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": "launch",
        "library_ms": None,
    })
    for name in HEX_KERNELS:
        d = hexk[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "s3gaussian_tpu_torch/csrc/hexplane.cu",
            # no Pallas kernel: the hexplane query XLA fuses, and its VJP
            "replaces": "s3gaussian_tpu/models/hexplane.py:69",
            "launches": hex_main[name],
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
        if sys.argv[1:2] == ["--dp-rank"]:
            code = dp_rank_main(*sys.argv[2:])
        elif sys.argv[1:] in (["--phase", "13"], ["--phase", "14"],
                              ["--phase", "15"]):
            code = main(only=sys.argv[2])
        else:
            code = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
