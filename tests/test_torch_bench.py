"""The port's bench (``s3gaussian_tpu_torch/bench.py``) against the
repository's ``bench.py``:

  * the workload's seeded draws (points, colours, RGB and depth targets)
    and its cameras (the single camera over a block's times, the shifted
    rig, the yawed street360 rig) are bit-equal to what ``bench.py``
    builds, read from inside its ``run_workload`` with the JAX package's
    constructors stubbed;
  * one fine step of the headline workload at a small size (2,000
    Gaussians in 2,048, 48x64, a narrow field in float32) equals the JAX
    ``train_step`` on the same pool and field, carried across through
    ``weights.py``, at ``test_torch_train.py``'s tolerances.  The state
    is made mid-training first (non-zero Adam moments, as
    ``test_torch_train.py`` does), so no update is the sign of a tiny
    gradient;
  * ``main`` on the CPU at a small size runs the four workloads (single
    camera, shifted rig, two-class single camera, culled two-class
    street360 rig) and prints ``bench.py``'s lines: the headline on
    stdout first and last, a detail line per workload on stderr with
    ``bench.py``'s keys but the listed changes;
  * without a card, ``main`` raises.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import PipelineParams as JPipe
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data import cameras as jcameras
from s3gaussian_tpu.models import deformation as jdeformation
from s3gaussian_tpu.models import pool as jpool
from s3gaussian_tpu.ops.transforms import projection_matrix as j_projection
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import bench
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.weights import train_state_from_numpy

import tiny_config
from test_torch_config import DROPPED
from test_torch_train import (assert_aux_match, assert_states_match,
                              mid_training, np_tree)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP_KW = dict(tiny_config.ModelHiddenParams, grid_compute_bf16=False)
T_HP = tcfg.ModelHiddenParams(**HP_KW)
J_HP = JHP(**HP_KW)
H, W = 48, 64

# bench.py's keys per line (bench.py:193-213; the headline's detail pops
# it_per_s into the headline and adds roofline_frac, :247-249; the 1.5 M
# line renames it_per_s, :317)
BENCH_PY_KEYS = {"backend", "session_s", "compile_s", "it_per_s", "n_pairs",
                 "overflow_pairs", "n_visible_overflow", "loss"}
DROPPED_KEYS = {"session_s", "compile_s", "roofline_frac"}
ADDED_KEYS = {"build_s", "steps_per_dispatch", "warmup_s", "capture_ms",
              "step_ms_median", "step_ms_min", "step_ms_max", "peak_gib",
              "launches", "launches_per_step"}
SMALL = [bench.Spec("detail", 2000, 2048, 1 << 22),
         bench.Spec("detail_multicam3", 2000, 2048, 1 << 22, multicam=3,
                    render_fps=False),
         bench.Spec("detail_waymo_scale", 3000, 4096, 1 << 23, 256),
         bench.Spec("detail_waymo_rig", 3000, 4096, 1 << 23, 128, multicam=3,
                    scene="street360", cull=True, max_visible=1024,
                    render_fps=False)]


@pytest.fixture
def narrow_field(monkeypatch):
    """The bench's field narrowed to tiny_config's, in float32."""
    monkeypatch.setattr(bench, "ModelHiddenParams", lambda: T_HP)


class _Captured(Exception):
    pass


def bench_py_build(monkeypatch, n, cap, multicam, scene):
    """What bench.py's run_workload builds before its first dispatch: the
    arguments of create_from_pcd and the cameras of its first block (the
    single camera's block, or the first rig)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench as bench_py

    seen = {}

    def create_from_pcd(pts, cols, capacity):
        seen["pcd"] = (pts, cols, capacity)

    def stack_cameras(cams):
        seen["cams"] = list(cams)
        raise _Captured

    monkeypatch.setattr(jpool, "create_from_pcd", create_from_pcd)
    monkeypatch.setattr(jdeformation, "init_deformation", lambda *a: None)
    monkeypatch.setattr(jtr, "init_state", lambda *a: None)
    monkeypatch.setattr(jcameras, "stack_cameras", stack_cameras)
    with pytest.raises(_Captured):
        bench_py.run_workload(n=n, cap=cap, pair_budget=1 << 22,
                              big_budget=0, chunk=128, scan_n=10, n_steps=20,
                              multicam=multicam, scene=scene,
                              cull=scene == "street360")
    return seen


@pytest.mark.parametrize("scene,multicam", [("frustum", 0), ("frustum", 3),
                                            ("street360", 3)])
def test_draws_and_cameras_equal_bench_py(monkeypatch, narrow_field, scene,
                                          multicam):
    seen = bench_py_build(monkeypatch, 1000, 1024, multicam, scene)
    pts, cols, gt, gt_depth = bench.draws(1000, scene)
    want_pts, want_cols, cap = seen["pcd"]
    assert cap == 1024
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(cols, want_cols)
    jcams = seen["cams"]
    np.testing.assert_array_equal(gt, np.asarray(jcams[0].image))
    np.testing.assert_array_equal(gt_depth, np.asarray(jcams[0].depth_map))

    spec = bench.Spec("x", 1000, 1024, 1 << 22, multicam=multicam,
                      scene=scene, cull=scene == "street360")
    wl = bench.Workload(spec, bench.H, bench.W, device="cpu")
    np.testing.assert_array_equal(wl.state.pool.xyz[:1000].numpy(), pts)
    got = ([wl.cameras(i)[0] for i in range(len(jcams))] if multicam == 0
           else wl.cameras(0))
    assert len(got) == len(jcams) == max(multicam, 10 * (multicam == 0))
    for g, j in zip(got, jcams):
        for k in ("world_view", "full_proj", "campos", "time"):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(j, k)), err_msg=k)
        assert (g.image_height, g.image_width) == (bench.H, bench.W)
        assert (g.fovx, g.fovy) == (float(j.fovx), float(j.fovy))
        assert g.image is wl.gt and g.depth_map is wl.gt_depth


def test_bench_fine_step_matches_jax(narrow_field):
    spec = bench.Spec("detail", 2000, 2048, 1 << 22)
    wl = bench.Workload(spec, H, W, device="cpu")
    pts, cols, gt, gt_depth = bench.draws(spec.n, spec.scene, H, W)
    jstate = mid_training(jtr.init_state(
        jpool.create_from_pcd(pts, cols, spec.cap),
        jdeformation.init_deformation(jax.random.PRNGKey(0), J_HP),
        jnp.asarray(bench.AABB)), np.random.default_rng(0))
    wl.state = train_state_from_numpy(np_tree(jstate), T_HP, device="cpu")
    # bench.py's camera (bench.py:100-108) and raster settings (:86-93);
    # the jnp compositor's per-tile cap is above the 2,000 pairs a tile
    # can hold here
    view = np.eye(4, dtype=np.float32)
    full = (view.T @ j_projection(0.01, 100.0, 1.0, 1.0).T).astype(
        np.float32)
    jcam = jcameras.Camera(
        world_view=jnp.asarray(view), full_proj=jnp.asarray(full),
        campos=jnp.zeros(3), time=jnp.asarray(0.4, jnp.float32),
        image=jnp.asarray(gt), depth_map=jnp.asarray(gt_depth),
        image_height=H, image_width=W, fovx=1.0, fovy=1.0)
    jcfg = JRasterConfig(tile_x=16, tile_y=16, max_visible=spec.cap,
                         rect_w=4, rect_h=4, pair_budget=spec.pair_budget,
                         chunk=128, big_budget=0, cull_before_deform=False,
                         max_pairs_per_tile=2048)
    assert dataclasses.asdict(wl.cfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in DROPPED["RasterConfig"]}
    js, jaux = jtr.train_step(jtr.clone_state(jstate), jcam, "fine", 3, J_HP,
                              JOpt(), JPipe(), jcfg, bench.SPATIAL_LR_SCALE,
                              jnp.zeros(3))
    taux = wl.step(wl.cameras(0))
    assert int(taux["n_pairs"]) > 0
    assert_aux_match(taux, jaux)
    assert_states_match(wl.state, np_tree(js), 1e-5)


def run_main(mp, specs, skip=()):
    """bench.main on the CPU at a small size over ``specs``, the
    ``S3G_BENCH_SKIP_*`` variables of ``skip`` set: (stdout lines, stderr
    JSON lines by key, the returned headline)."""
    out, err = io.StringIO(), io.StringIO()
    mp.setattr(bench, "ModelHiddenParams", lambda: T_HP)
    mp.setattr(bench, "default_specs", lambda: specs)
    mp.setenv("BENCH_SCAN", "2")
    mp.setenv("BENCH_STEPS", "2")
    for k in ("MULTICAM", "FULL", "RIG"):
        if k in skip:
            mp.setenv(f"S3G_BENCH_SKIP_{k}", "1")
        else:
            mp.delenv(f"S3G_BENCH_SKIP_{k}", raising=False)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        headline = bench.main("cpu", H, W)
    details = {}
    for line in err.getvalue().splitlines():
        if line.startswith("{"):
            details.update(json.loads(line))
    return out.getvalue().splitlines(), details, headline


@pytest.fixture(scope="module")
def printed():
    with pytest.MonkeyPatch.context() as mp:
        return run_main(mp, SMALL)


def test_headline_lines(printed):
    lines, _, headline = printed
    first, last = (json.loads(x) for x in (lines[0], lines[-1]))
    assert first == {"metric": f"train_iters_per_sec_{H}x{W}_fine",
                     "value": first["value"], "unit": "it/s"}
    assert first["value"] > 0
    assert last == headline == dict(first, rig_cams_per_s=last[
        "rig_cams_per_s"])


@pytest.mark.parametrize("spec", SMALL, ids=[s.key for s in SMALL])
def test_detail_lines_keep_bench_py_keys(printed, spec):
    _, details, headline = printed
    assert list(details) == [s.key for s in SMALL]
    got = details[spec.key]
    want = set(BENCH_PY_KEYS)
    if spec.multicam > 1:
        want.add("cams_per_s")
    if spec.render_fps:
        want.add("render_fps")
    if spec.key == "detail":
        want |= {"roofline_frac"}
        want.remove("it_per_s")
    if spec.key == "detail_waymo_scale":
        want.remove("it_per_s")
        want.add("it_per_s_1p5m")
    assert set(got) == (want - DROPPED_KEYS) | ADDED_KEYS
    assert got["backend"] == "cpu" and got["build_s"] is None
    assert got["peak_gib"] is None and got["capture_ms"] is None
    assert got["steps_per_dispatch"] == 2
    assert got["overflow_pairs"] == 0 and np.isfinite(got["loss"])
    assert got["step_ms_min"] <= got["step_ms_median"] <= got["step_ms_max"]
    # the plain compositors on the CPU: no kernel launch
    assert got["launches"] == [0, 0]
    assert got["launches_per_step"] == [0, 0]
    if spec.key == "detail_waymo_rig":
        assert headline["rig_cams_per_s"] == got["cams_per_s"]


def test_a_failing_workload_prints_its_error_line(monkeypatch):
    """A detail workload that fails (here: a pair budget it overflows)
    prints its error line and the run goes on; S3G_BENCH_SKIP_FULL ends it
    before both 1.5 M workloads, as in bench.py."""
    tight = dataclasses.replace(SMALL[1], pair_budget=1 << 10)
    lines, details, headline = run_main(monkeypatch, [SMALL[0], tight]
                                        + SMALL[2:], skip=("FULL",))
    assert list(details) == ["detail", "detail_multicam3"]
    assert details["detail_multicam3"] == {
        "error": details["detail_multicam3"]["error"]}
    assert "pair budget saturated" in details["detail_multicam3"]["error"]
    assert [json.loads(x) for x in lines] == [headline, headline]
    assert "rig_cams_per_s" not in headline


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
