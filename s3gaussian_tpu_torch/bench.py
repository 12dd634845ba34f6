"""Fine-stage training throughput of the port on the card (counterpart of
the repository's ``bench.py``), run from the repository root:

    python -m s3gaussian_tpu_torch.bench

It runs ``bench.py``'s four workloads, each built as ``bench.py`` builds
it: the same seeded numpy draws (a "frustum" cloud of LiDAR-like points
in the view, or the "street360" cloud around the ego), colours, a random
RGB target and LiDAR-like depth; ``create_from_pcd``; the default model,
optimizer and pipeline settings; the rasterizer's 16x16 tiles and 4x4
rect cap; the aabb ``[[80,80,80],[-80,-80,-10]]``; the identity camera
with ``projection_matrix(0.01, 100, 1, 1)``.  A rig of B cameras shifts
them 0.5 apart along x, or, in the street360 cloud, yaws them 40 degrees
apart.  Step i runs at time 0.4 + 1e-4·i (stage fine, SH degree 3).

  headline             200,000 in 204,800, pair budget 2^22
  detail_multicam3     the same scene, rigs of 3 shifted cameras
  detail_waymo_scale   1.5 M in 1,507,328, pair budget 2^23,
                       big_budget 262,144
  detail_waymo_rig     street360 1.5 M, rigs of 3 yawed cameras, the
                       union cull to 589,824 rows, big_budget 131,072

The unit of work is ``bench.py``'s: a block of ``BENCH_SCAN`` steps (10)
in one dispatch (``trainer.train_steps_scan``, ``..._multicam``), on the
card the replays of the step captured as one CUDA graph, step i of a
block at time 0.4 + 1e-4·i.  Each workload runs one warm-up block (on
the card the capture, timed alone as ``capture_ms``, then its replays),
then ``BENCH_STEPS // BENCH_SCAN`` timed blocks (at least one) on the
host clock, ending in ``torch.cuda.synchronize()``: ``it_per_s`` is
steps over seconds.  Beside it, each step's time from CUDA events
recorded between the replays (median, min, max) and the peak device
memory, the graph's pool included.  ``render_fps`` times as many
renders without gradient as timed steps, the time shifted by 1e-6·i,
each followed by a host fetch: on the card replays of ``render()``
captured as one CUDA graph, as ``bench.py`` times a jitted ``fwd_only``
(``bench.py:218-233``); the capture comes first, untimed.  The last step must drop no pair
and end with a finite loss.

Output keeps ``bench.py``'s lines: the headline ``{"metric":
"train_iters_per_sec_640x960_fine", "value", "unit": "it/s"}`` on
stdout first and again last (then with ``rig_cams_per_s``); the
``detail``, ``detail_multicam3``, ``detail_waymo_scale`` (its rate as
``it_per_s_1p5m``) and ``detail_waymo_rig`` lines on stderr, or a
workload's ``{"error": ...}``.  Against ``bench.py``: ``backend`` is the
card's name and power limit (``nvidia-smi``); ``session_s`` and
``compile_s`` become ``build_s`` (the kernels' ``nvcc`` build) and
``warmup_s`` (the warm-up block, capture included); ``vs_baseline`` and
``roofline_frac`` are gone (they divided by an assumed rate and another
device's constant); added are ``steps_per_dispatch``, ``capture_ms``,
``step_ms_median``/``_min``/``_max``, ``peak_gib`` and the compositor
launches (``launches`` over the workload, ``launches_per_step`` over the
timed steps, forward and backward; a replay counts the launches its
graph captured).

Environment: ``BENCH_STEPS`` (timed steps, 20), ``BENCH_SCAN`` (steps a
dispatch, 10), ``S3G_BENCH_SKIP_MULTICAM``, ``S3G_BENCH_SKIP_FULL``
(skips both 1.5 M workloads, as in ``bench.py``), ``S3G_BENCH_SKIP_RIG``,
``BENCH_BIG_BUDGET``, ``BENCH_FULL_BIG_BUDGET``, ``BENCH_RIG_BIG_BUDGET``
and ``BENCH_RIG_MAX_VISIBLE``.  ``BENCH_CHUNK`` is gone: the CUDA
compositors take their pairs in fixed batches of 128
(``csrc/composite_common.cuh``) and read no ``RasterConfig.chunk``.
``BENCH_FULL_REMAT`` and ``BENCH_RIG_SCAN`` are gone with
``remat_deform`` and ``multicam_scan``, which the port does not have.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                         OptimizationParams, PipelineParams,
                                         RasterConfig)
from s3gaussian_tpu_torch.data.cameras import Camera, half_angle_tan
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import create_from_pcd
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.transforms import projection_matrix
from s3gaussian_tpu_torch.render.renderer import render
from s3gaussian_tpu_torch.train import graphs
from s3gaussian_tpu_torch.train.trainer import (TrainState, init_state,
                                                last_step, train_step,
                                                train_step_multicam,
                                                train_steps_scan,
                                                train_steps_scan_multicam)

H, W = 640, 960
SPATIAL_LR_SCALE = 30.0
AABB = [[80.0, 80.0, 80.0], [-80.0, -80.0, -10.0]]
RIG_SHIFT = 0.5          # frustum rigs: camera b at x = -0.5·b
RIG_YAW_DEG = 40.0       # street360 rigs: the Waymo front cameras


@dataclasses.dataclass(frozen=True)
class Spec:
    """One workload of ``bench.py``: its JSON key, ``n`` points in a pool
    of ``cap``, the rasterizer budgets, the rig size (0: one camera), the
    cloud, the cull and whether render fps is timed."""
    key: str
    n: int
    cap: int
    pair_budget: int
    big_budget: int = 0
    multicam: int = 0
    scene: str = "frustum"
    cull: bool = False
    max_visible: int = 0
    render_fps: bool = True


def default_specs() -> List[Spec]:
    """``bench.py``'s four workloads (``bench.py:255-346``), with its
    environment's budget overrides."""
    env = os.environ.get
    return [
        Spec("detail", 200_000, 204_800, 1 << 22,
             int(env("BENCH_BIG_BUDGET", "0"))),
        Spec("detail_multicam3", 200_000, 204_800, 1 << 22, 0, multicam=3,
             render_fps=False),
        Spec("detail_waymo_scale", 1_500_000, 1_507_328, 1 << 23,
             int(env("BENCH_FULL_BIG_BUDGET", "262144"))),
        Spec("detail_waymo_rig", 1_500_000, 1_507_328, 1 << 23,
             int(env("BENCH_RIG_BIG_BUDGET", "131072")), multicam=3,
             scene="street360", cull=True,
             max_visible=int(env("BENCH_RIG_MAX_VISIBLE", "589824")),
             render_fps=False),
    ]


def cloud(n: int, scene: str, rng: np.random.Generator):
    """``bench.py``'s point cloud from ``rng``: points [n, 3] and colours
    [n, 3] float32."""
    if scene == "street360":
        # LiDAR-like 360-degree street cloud around the ego
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(2.0, 60.0, n)
        y = rng.uniform(-1.5, 6.0, n)
        pts = np.stack([rad * np.sin(ang), y, rad * np.cos(ang)],
                       1).astype(np.float32)
    else:
        tan = np.tan(0.5)
        z = rng.uniform(1.0, 60.0, n)
        pts = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                        rng.uniform(-0.9, 0.9, n) * tan * z, z],
                       1).astype(np.float32)
    return pts, rng.random((n, 3)).astype(np.float32)


def draws(n: int, scene: str, h: int = H, w: int = W, seed: int = 0):
    """``bench.py``'s seeded draws in its order: points [n, 3], colours
    [n, 3], the RGB target [h, w, 3] and the depth target [h, w]."""
    rng = np.random.default_rng(seed)
    pts, cols = cloud(n, scene, rng)
    gt = rng.random((h, w, 3)).astype(np.float32)
    gt_depth = rng.uniform(1, 70, (h, w)).astype(np.float32)
    return pts, cols, gt, gt_depth


def rig_view(spec: Spec, b: Optional[int]):
    """Row-vector world-view, full projection and centre of camera ``b``
    of a rig (``bench.py``'s ``shifted`` / ``yawed``), or of the single
    camera (``b`` None): numpy float32."""
    proj = projection_matrix(0.01, 100.0, 1.0, 1.0)
    view = np.eye(4, dtype=np.float32)
    campos = np.zeros(3, np.float32)
    if b is not None and spec.scene == "street360":
        yaw = (b - (spec.multicam - 1) / 2) * np.deg2rad(RIG_YAW_DEG)
        cy, sy = np.cos(yaw), np.sin(yaw)
        view[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]],
                                np.float32)
    elif b is not None:
        view[3, 0] += RIG_SHIFT * b
        campos[0] = -RIG_SHIFT * b
    full = (view @ proj.T).astype(np.float32)
    return view, full, campos


class Workload:
    """A workload built on ``device``: the train state, the settings, the
    targets and the cameras of every step."""

    def __init__(self, spec: Spec, h: int = H, w: int = W,
                 device: torch.device | str = "cuda"):
        dev = torch.device(device)
        pts, cols, gt, gt_depth = draws(spec.n, spec.scene, h, w)
        self.spec, self.h, self.w = spec, h, w
        self.hp = ModelHiddenParams()
        self.opt, self.pipe = OptimizationParams(), PipelineParams()
        self.cfg = RasterConfig(tile_x=16, tile_y=16,
                                max_visible=spec.max_visible or spec.cap,
                                rect_w=4, rect_h=4,
                                pair_budget=spec.pair_budget,
                                big_budget=spec.big_budget,
                                cull_before_deform=spec.cull)
        self.state: TrainState = init_state(
            create_from_pcd(pts, cols, spec.cap, device=dev),
            DeformationField(self.hp, torch.Generator().manual_seed(0), dev),
            torch.tensor(AABB, device=dev))
        self.bg = torch.zeros(3, device=dev)
        self.gt = torch.as_tensor(gt, device=dev)
        self.gt_depth = torch.as_tensor(gt_depth, device=dev)
        rigs = [None] if spec.multicam <= 1 else range(spec.multicam)
        self._views = [tuple(torch.as_tensor(x, device=dev)
                             for x in rig_view(spec, b)) for b in rigs]
        self._tan = half_angle_tan(1.0, dev)
        self._block: List[List[Camera]] = []

    def camera(self, view, t: torch.Tensor) -> Camera:
        world_view, full, campos = view
        return Camera(world_view=world_view, full_proj=full, campos=campos,
                      time=t, fovx=1.0, fovy=1.0, image_height=self.h,
                      image_width=self.w, image=self.gt,
                      depth_map=self.gt_depth, tanfovx=self._tan,
                      tanfovy=self._tan)

    def cameras(self, i: int) -> List[Camera]:
        """The camera, or the rig, of step ``i``."""
        t = torch.tensor(0.4 + 1e-4 * i, dtype=torch.float32,
                         device=self.bg.device)
        return [self.camera(v, t) for v in self._views]

    def _args(self) -> tuple:
        return ("fine", 3, self.hp, self.opt, self.pipe, self.cfg,
                SPATIAL_LR_SCALE, self.bg)

    def step(self, cams: Sequence[Camera]) -> Dict[str, Any]:
        """One eager fine train step on ``cams``; returns its aux."""
        if self.spec.multicam > 1:
            self.state, aux = train_step_multicam(self.state, cams,
                                                  *self._args())
        else:
            self.state, aux = train_step(self.state, cams[0], *self._args())
        return aux

    def block(self, n: int, marks: Optional[List[Any]] = None
              ) -> Dict[str, Any]:
        """A block of ``n`` fine train steps in one dispatch, step i on
        ``cameras(i)`` (made once, as ``bench.py`` stacks its block
        once); returns the last step's ``small_aux``.  On the card
        ``marks`` receives a CUDA event before the first step and after
        each."""
        if len(self._block) != n:
            self._block = [self.cameras(i) for i in range(n)]
        if self.spec.multicam > 1:
            self.state, aux = train_steps_scan_multicam(
                self.state, self._block, self.spec.multicam, *self._args(),
                marks=marks)
        else:
            self.state, aux = train_steps_scan(
                self.state, [c[0] for c in self._block], *self._args(),
                marks=marks)
        return last_step(aux)

    def render(self, tshift: float) -> torch.Tensor:
        """The single camera's image at time 0.4 + ``tshift``, no
        gradient: on the card a replay of the render captured as one CUDA
        graph (``bench.py`` times a jitted ``fwd_only``), the camera's
        time in its buffer."""
        cam = dataclasses.replace(
            self.camera(self._views[0], torch.tensor(
                0.4, dtype=torch.float32, device=self.bg.device) + tshift),
            image=None, depth_map=None)
        with torch.no_grad():
            if self.bg.is_cuda:
                key = ("bench render", id(self), self.state.pool.xyz.data_ptr())
                return graphs.render_graph(key, self._render, [cam],
                                           {}).run([cam])
            return self._render([cam])

    def _render(self, cams: Sequence[Camera]) -> torch.Tensor:
        return render(cams[0], self.state.pool, self.state.deform, self.pipe,
                      self.bg, self.state.aabb, 3, stage="fine",
                      cfg=self.cfg)["render"]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_blocks(wl: Workload, n_blocks: int, scan_n: int):
    """``n_blocks`` blocks of ``scan_n`` steps on the host clock; (last
    step's aux, seconds, ms of each step: CUDA events between the replays
    on the card, a block's host time over its steps on the CPU)."""
    dev = wl.bg.device
    on_card = dev.type == "cuda"
    marks, ms = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        if on_card:
            block_marks: List[Any] = []
            aux = wl.block(scan_n, block_marks)
            marks.append(block_marks)
        else:
            t = time.perf_counter()
            aux = wl.block(scan_n)
            ms += [(time.perf_counter() - t) * 1e3 / scan_n] * scan_n
    _sync(dev)
    seconds = time.perf_counter() - t0
    if on_card:
        ms = [a.elapsed_time(b) for m in marks for a, b in zip(m, m[1:])]
    return aux, seconds, ms


def run_workload(spec: Spec, n_steps: int, h: int = H, w: int = W,
                 device: torch.device | str = "cuda") -> Dict[str, Any]:
    """Build ``spec``'s workload and measure it: a warm-up block, then
    ``n_steps // BENCH_SCAN`` timed blocks (at least one) and, where the
    spec asks, render fps.  Returns the detail dict of its JSON line."""
    dev = configure_device(str(device))
    on_card = dev.type == "cuda"
    build_s = None
    if on_card:
        t0 = time.perf_counter()
        tk.build()
        build_s = round(time.perf_counter() - t0, 3)
        torch.cuda.reset_peak_memory_stats(dev)
    wl = Workload(spec, h, w, dev)
    l0 = (tk.launches, tk.bwd_launches)
    scan_n = max(int(os.environ.get("BENCH_SCAN", "10")), 1)
    n_blocks = max(n_steps // scan_n, 1)

    t0 = time.perf_counter()
    wl.block(scan_n)
    _sync(dev)
    warmup_s = time.perf_counter() - t0
    capture_ms = graphs.current().capture_ms if on_card else None

    lt = (tk.launches, tk.bwd_launches)
    aux, seconds, ms = _timed_blocks(wl, n_blocks, scan_n)
    total = n_blocks * scan_n
    per_step = [(tk.launches - lt[0]) / total,
                (tk.bwd_launches - lt[1]) / total]
    it_per_s = total / seconds
    overflow_pairs = int(aux["overflow_pairs"])
    if overflow_pairs != 0:
        raise RuntimeError(
            f"pair budget saturated ({overflow_pairs} pairs dropped): the "
            "it/s would be an artifact of the clamp; raise pair_budget")
    loss = float(aux["metrics"]["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite bench loss {loss}")

    out: Dict[str, Any] = {
        "backend": card_line() if on_card else "cpu",
        "build_s": build_s,
        "steps_per_dispatch": scan_n,
        "warmup_s": round(warmup_s, 3),
        "capture_ms": (round(capture_ms, 3) if capture_ms is not None
                       else None),
        "it_per_s": round(it_per_s, 4),
        "step_ms_median": round(float(np.median(ms)), 3),
        "step_ms_min": round(min(ms), 3),
        "step_ms_max": round(max(ms), 3),
        "peak_gib": (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
                     if on_card else None),
        "n_pairs": int(aux["n_pairs"]),
        "overflow_pairs": overflow_pairs,
        "n_visible_overflow": int(aux["overflow_visible"]),
        "loss": round(loss, 5),
    }
    if spec.multicam > 1:
        out["cams_per_s"] = round(it_per_s * spec.multicam, 4)
    graphs.release()
    if spec.render_fps:
        float(wl.render(0.0).reshape(-1)[:4].sum())
        t0 = time.perf_counter()
        for i in range(total):
            float(wl.render(1e-6 * i).reshape(-1)[:4].sum())
        out["render_fps"] = round(total / (time.perf_counter() - t0), 3)
        graphs.release()
    out["launches"] = [tk.launches - l0[0], tk.bwd_launches - l0[1]]
    out["launches_per_step"] = per_step
    return out


def _emit(line: Dict[str, Any], stream=None) -> None:
    print(json.dumps(line), file=stream or sys.stdout, flush=True)


def _detail(spec: Spec, n_steps: int, h: int, w: int, device: str
            ) -> Optional[Dict[str, Any]]:
    """A detail workload's line on stderr, or its error line; never
    raises (a detail workload must not break the headline)."""
    try:
        res = run_workload(spec, n_steps, h, w, device)
    except Exception as e:      # noqa: BLE001 - reported, then go on
        traceback.print_exc()
        _emit({spec.key: {"error": str(e)[:300]}}, sys.stderr)
        return None
    finally:
        graphs.release()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if spec.key == "detail_waymo_scale":
        res["it_per_s_1p5m"] = res.pop("it_per_s")
    _emit({spec.key: res}, sys.stderr)
    return res


def main(device: str = "cuda", h: int = H, w: int = W) -> Dict[str, Any]:
    """Run the four workloads on ``device`` and print their lines; returns
    the headline.  Without a card it raises."""
    configure_device(device)
    head, multicam, full, rig = default_specs()
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    res = run_workload(head, n_steps, h, w, device)
    headline = {"metric": f"train_iters_per_sec_{h}x{w}_fine",
                "value": res.pop("it_per_s"), "unit": "it/s"}
    _emit(headline)
    _emit({head.key: res}, sys.stderr)
    if not os.environ.get("S3G_BENCH_SKIP_MULTICAM"):
        _detail(multicam, n_steps, h, w, device)
    # a reader of the output takes the last JSON line on stdout, so the
    # headline comes again at the end
    if not os.environ.get("S3G_BENCH_SKIP_FULL"):
        _detail(full, n_steps, h, w, device)
        if not os.environ.get("S3G_BENCH_SKIP_RIG"):
            res = _detail(rig, n_steps, h, w, device)
            if res is not None:
                headline["rig_cams_per_s"] = res["cams_per_s"]
    _emit(headline)
    return headline


if __name__ == "__main__":
    main()
