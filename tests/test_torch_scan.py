"""The port's blocks of steps against the JAX package's, on the CPU.

  * ``train_steps_scan`` (3 steps) against JAX's ``train_steps_scan`` from
    ``test_torch_train.py``'s mid-training state, on cameras that differ
    in pose, time and field of view: every step's metrics and small aux
    (leading axis 3; metrics rtol 1e-5, counters, ``radii_max`` and
    ``n_r20`` exact), then the state at the three-step tolerance of
    ``test_torch_train.py`` (1e-4·max|want|);
  * ``train_steps_scan_multicam`` (2 rigs of 3) against JAX's, the JAX
    side running its ``multicam_scan`` core as ``test_torch_multicam.py``
    does;
  * the data-parallel block at world size 1 (a gloo group in this
    process) equal to ``train_steps_scan`` bit for bit;
  * the CLI's block rule: ``train.py`` and the port's CLI on the Waymo
    fixture over a schedule with logs, densifies, opacity resets, a
    prune-only tail, checkpoints, a snapshot and an SH bump (and a run
    ending at ``--bench_iters``), each step function stubbed to record
    its dispatch: the same dispatches (block or single step, its size,
    its SH degree, its cameras' times) and the same logger lines;
    ``dispatch_refusal`` refuses a block over gloo on the card;
  * ``eval_sh_dynamic`` against JAX's at degrees 0-3 (``test_torch_project
    .py``'s tolerance) and equal to ``eval_sh``; the SH colours at a
    tensor degree equal those at the Python degree;
  * the cameras' tangents as 0-d float32 tensors: the projection takes
    them as it takes floats, and the render at other fields of view
    equals JAX's (``test_torch_render.py``'s tolerances);
  * what ``train/graphs.py`` does without a card: the graph's key, the
    state copy of its warm-up, and ``load_state``, which copies only the
    tensors that moved.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import PipelineParams as JPipe
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.data.cameras import stack_cameras
from s3gaussian_tpu.ops import sh as jsh
from s3gaussian_tpu.render.renderer import render as j_render
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.models.pool import PoolStats
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.ops import project as tproject
from s3gaussian_tpu_torch.ops import sh as tsh
from s3gaussian_tpu_torch.parallel import data_parallel as tdp
from s3gaussian_tpu_torch.parallel.multihost import init_multihost
from s3gaussian_tpu_torch.render.renderer import render as t_render
from s3gaussian_tpu_torch.train import checkpoints as tckpt
from s3gaussian_tpu_torch.train import graphs
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.weights import train_state_from_numpy

from test_torch_render import AABB as R_AABB
from test_torch_render import CFG as R_CFG
from test_torch_render import _close as r_close
from test_torch_render import _scene
from test_torch_train import (CAP, H, J_CFG, J_HP, J_OPT, J_PIPE,
                              SPATIAL_LR_SCALE, T_CFG, T_HP, T_OPT, T_PIPE,
                              W, assert_states_match, jax_state, np_tree)
from torch_threads import one_torch_thread  # noqa: F401
from waymo_fixture import make_fixture

__all__ = ["jax_state"]

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny_config.py")
# (fovx, fovy) of the block's cameras in turn
FOVS = ((1.0, 0.8), (0.9, 0.72), (1.15, 0.85))
SMALL_AUX_COUNTERS = ("n_pairs", "overflow_rect", "overflow_visible",
                      "overflow_pairs", "radii_max", "n_r20")


def camera(i, time, yaw_deg, fov, seed):
    """(JAX camera, port camera) ``i`` with its own pose, time, field of
    view, random image and LiDAR-like depth."""
    rng = np.random.default_rng(seed)
    image = rng.random((H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 12, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.3] = 0.0
    yaw = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    T = np.array([0.2 + 0.05 * i, -0.1, 0.3])
    kw = dict(time=time, image=image, depth_map=depth)
    return (j_make_camera(R, T, *fov, W, H, **kw),
            t_make_camera(R, T, *fov, W, H, device="cpu", **kw))


def assert_small_aux_match(taux, jaux, n):
    assert sorted(taux["metrics"]) == sorted(jaux["metrics"])
    for k, v in taux["metrics"].items():
        assert v.shape == (n,), k
        np.testing.assert_allclose(v.numpy(), np.asarray(jaux["metrics"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in SMALL_AUX_COUNTERS:
        assert taux[k].shape == (n,), k
        np.testing.assert_array_equal(taux[k].numpy().astype(np.float64),
                                      np.asarray(jaux[k], np.float64),
                                      err_msg=k)


def test_train_steps_scan_matches_jax(jax_state):
    cams = [camera(i, 0.3 + 0.2 * i, 7.0 * (i - 1), FOVS[i], 40 + i)
            for i in range(3)]
    js, jaux = jtr.train_steps_scan(
        jtr.clone_state(jax_state), stack_cameras([c[0] for c in cams]),
        "fine", 2, J_HP, J_OPT, J_PIPE, J_CFG, SPATIAL_LR_SCALE,
        jnp.zeros(3))
    tstate = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    ts, taux = ttr.train_steps_scan(tstate, [c[1] for c in cams], "fine", 2,
                                    T_HP, T_OPT, T_PIPE, T_CFG,
                                    SPATIAL_LR_SCALE, torch.zeros(3))
    assert ts is tstate                    # written into the state's tensors
    assert_small_aux_match(taux, jaux, 3)
    assert int(taux["n_pairs"].min()) > 0
    assert_states_match(ts, np_tree(js), 1e-4)


def test_train_steps_scan_multicam_matches_jax(jax_state):
    rigs = [[camera(3 * r + b, 0.35 + 0.3 * r, (-8.0, 0.0, 8.0)[b],
                    FOVS[(r + b) % 3], 60 + 3 * r + b) for b in range(3)]
            for r in range(2)]
    j_cfg = JRasterConfig(max_visible=CAP, pair_budget=1 << 16,
                          multicam_scan=True)
    js, jaux = jtr.train_steps_scan_multicam(
        jtr.clone_state(jax_state),
        stack_cameras([stack_cameras([c[0] for c in rig]) for rig in rigs]),
        3, "fine", 3, J_HP, JOpt(), J_PIPE, j_cfg, SPATIAL_LR_SCALE,
        jnp.zeros(3))
    tstate = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    ts, taux = ttr.train_steps_scan_multicam(
        tstate, [[c[1] for c in rig] for rig in rigs], 3, "fine", 3, T_HP,
        tcfg.OptimizationParams(), T_PIPE, T_CFG, SPATIAL_LR_SCALE,
        torch.zeros(3))
    assert_small_aux_match(taux, jaux, 2)
    assert_states_match(ts, np_tree(js), 1e-4)
    with pytest.raises(ValueError, match="n_cams=2"):
        ttr.train_steps_scan_multicam(
            ts, [[c[1] for c in rig] for rig in rigs], 2, "fine", 3, T_HP,
            tcfg.OptimizationParams(), T_PIPE, T_CFG, SPATIAL_LR_SCALE,
            torch.zeros(3))


def test_parallel_block_at_world_one_equals_the_block(jax_state, tmp_path):
    cams = [camera(i, 0.3 + 0.2 * i, 7.0 * (i - 1), FOVS[i], 40 + i)[1]
            for i in range(3)]
    args = ("fine", 3, T_HP, T_OPT, T_PIPE, T_CFG, SPATIAL_LR_SCALE,
            torch.zeros(3))
    one, one_aux = ttr.train_steps_scan(
        train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu"), cams,
        *args)
    assert init_multihost("file://" + str(tmp_path / "store"), 1, 0,
                          device="cpu") == (0, 1)
    try:
        dp, dp_aux = tdp.parallel_train_steps_scan(
            train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu"),
            cams, *args)
    finally:
        torch.distributed.destroy_process_group()
    for k, v in tckpt.state_tensors(one).items():
        assert torch.equal(tckpt.state_tensors(dp)[k], v), k
    for k, v in one_aux["metrics"].items():
        assert torch.equal(dp_aux["metrics"][k], v), k
    for k in SMALL_AUX_COUNTERS:
        assert torch.equal(dp_aux[k], one_aux[k]), k


# --------------------------------------------------------------------------
# the CLI's block rule, read off train.py's own loop
# --------------------------------------------------------------------------

# logs every LOG_EVERY; densify from 5 every 30 up to 700, then prune-only
# every 30; opacity resets every 250; checkpoints at 17 and 1003; the
# snapshot at 999 and the SH bump at 1000 of the fine stage
SCHEDULE = ["--num_pts", "500", "--coarse_iterations", "40",
            "--iterations", "1100", "--densify_from_iter", "5",
            "--densification_interval", "30", "--densify_until_iter", "700",
            "--prune_after_densify", "1", "--opacity_reset_interval", "250",
            "--checkpoint_iterations", "17", "1003", "--load_h", "64",
            "--load_w", "96", "--configs", TINY, "--skip_final_eval"]
LOG_EVERY = {"full": "45", "bench": "15"}
BENCH = {"full": [], "bench": ["--bench_iters", "33"]}


def small(n):
    z = np.zeros(n, np.float32)
    return {"metrics": {"loss": z + 0.5, "psnr": z + 10.0}, "n_pairs": z,
            "overflow_rect": z, "overflow_visible": z, "overflow_pairs": z,
            "radii_max": z, "n_r20": z}


@contextlib.contextmanager
def recorded_jax_cli(log):
    """``train.py``'s step functions, density control, checkpoints and
    snapshots stubbed: each dispatch appends (kind, steps, SH degree,
    camera times) to ``log``."""
    from s3gaussian_tpu.eval import snapshots as jsnap
    from s3gaussian_tpu.train import checkpoints as jckpt

    def step(state, cam, stage, sh, *a):
        log.append(("step", 1, int(sh), [round(float(cam.time), 6)]))
        return state, {k: ({m: x[0] for m, x in v.items()}
                           if k == "metrics" else v[0])
                       for k, v in small(1).items()}

    def scan(state, block, stage, sh, *a):
        times = [round(float(x), 6) for x in np.asarray(block.time)]
        log.append(("scan", len(times), int(sh), times))
        return state, small(len(times))

    def densify(state, *a, **k):
        return state, {"n_alive": 1}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "train_step", step)
        mp.setattr(jtr, "train_steps_scan", scan)
        mp.setattr(jtr, "densify_step", densify)
        mp.setattr(jtr, "opacity_reset_step", lambda s: s)
        mp.setattr(jckpt, "save_checkpoint", lambda *a, **k: None)
        mp.setattr(jckpt, "save_ply_pool", lambda *a, **k: None)
        mp.setattr(jsnap, "render_training_image", lambda *a, **k: None)
        yield mp


@contextlib.contextmanager
def recorded_port_cli(log):
    """The port CLI's, stubbed alike."""
    from s3gaussian_tpu_torch.eval import snapshots as tsnap

    def step(state, cam, stage, sh, *a):
        log.append(("step", 1, int(sh), [round(float(cam.time), 6)]))
        return state, {"metrics": {"loss": torch.tensor(0.5),
                                   "psnr": torch.tensor(10.0)},
                       **{k: torch.tensor(0) for k in (
                           "n_pairs", "overflow_rect", "overflow_visible",
                           "overflow_pairs")},
                       "radii": torch.zeros(4), "visible": torch.zeros(
                           4, dtype=torch.bool)}

    def scan(state, views, stage, sh, *a, **k):
        times = [round(float(c.time), 6) for c in views]
        log.append(("scan", len(times), int(sh), times))
        return state, {k: ({m: torch.from_numpy(x) for m, x in v.items()}
                           if k == "metrics" else torch.from_numpy(v))
                       for k, v in small(len(times)).items()}

    def densify(state, *a, **k):
        return state, {"n_alive": torch.tensor(1)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli, "train_step", step)
        mp.setattr(train_cli, "train_steps_scan", scan)
        mp.setattr(train_cli, "densify_step", densify)
        mp.setattr(train_cli, "opacity_reset_step", lambda s: s)
        mp.setattr(tckpt, "save_checkpoint", lambda *a, **k: None)
        mp.setattr(tckpt, "save_ply_pool", lambda *a, **k: None)
        mp.setattr(tsnap, "render_training_image", lambda *a, **k: None)
        yield mp


def logged(path):
    """(stage, step, kind) of every logger line."""
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return [(l["stage"], l["step"], sorted(set(l) - {"stage", "step"})[0]
             if "Loss" not in l else "Loss") for l in lines]


@pytest.fixture(scope="module")
def fixture_clip(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("scan") / "clip"),
                        n_frames=3)


@pytest.mark.parametrize("run", sorted(LOG_EVERY))
def test_cli_blocks_follow_train_py(fixture_clip, tmp_path, run):
    sys.path.insert(0, REPO)
    import train as jax_cli

    jlog, tlog = [], []
    argv = SCHEDULE + BENCH[run]
    with contextlib.redirect_stdout(io.StringIO()):
        with recorded_jax_cli(jlog) as mp:
            mp.setenv("S3G_LOG_EVERY", LOG_EVERY[run])
            jax_cli.main(["-s", fixture_clip, "--model_path",
                          str(tmp_path / "jax")] + argv)
        with recorded_port_cli(tlog) as mp:
            mp.setenv("S3G_LOG_EVERY", LOG_EVERY[run])
            train_cli.main(["-s", fixture_clip, "--model_path",
                            str(tmp_path / "port")] + argv, device="cpu")
    assert tlog == jlog
    kinds = {(k, n) for k, n, _, _ in jlog}
    assert ("scan", 10) in kinds and ("step", 1) in kinds
    if run == "full":                  # the SH bump at fine step 1000
        assert {sh for *_, sh, _ in jlog} == {0, 1}
    assert logged(str(tmp_path / "port" / "logger.json")) == logged(
        str(tmp_path / "jax" / "logger.json"))


def test_cli_refuses_blocks_over_gloo_on_the_card(monkeypatch, tmp_path):
    """Two gloo ranks on the card (the group's rank, size and backend
    stubbed): ``--steps_per_dispatch 10`` exits before the scene is read,
    naming ``--steps_per_dispatch 1``."""
    monkeypatch.setattr(train_cli, "init_multihost", lambda **k: (0, 2))
    monkeypatch.setattr(train_cli.dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(train_cli, "load_scene", None)   # never reached
    with pytest.raises(SystemExit, match="--steps_per_dispatch 1"):
        train_cli.main(["-s", str(tmp_path), "--model_path",
                        str(tmp_path / "out"), "--batch_size", "2"],
                       device="cuda")


def test_dispatch_refusal_names_step_by_step():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    why = train_cli.dispatch_refusal(10, cuda, "gloo")
    assert "--steps_per_dispatch 1" in why and "gloo" in why
    for args in ((1, cuda, "gloo"), (10, cpu, "gloo"), (10, cuda, "nccl"),
                 (10, cuda, None)):
        assert train_cli.dispatch_refusal(*args) is None, args


# --------------------------------------------------------------------------
# SH at a tensor degree; tangents as tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_dynamic_matches_jax(deg):
    rng = np.random.default_rng(20 + deg)
    sh = rng.normal(size=(53, 3, 16)).astype(np.float32)
    d = rng.normal(size=(53, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tsh.eval_sh_dynamic(torch.tensor(deg, dtype=torch.int32),
                              torch.from_numpy(sh), torch.from_numpy(d))
    want = jsh.eval_sh_dynamic(jnp.asarray(deg, jnp.int32), jnp.asarray(sh),
                               jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), tsh.eval_sh(deg, torch.from_numpy(sh),
                                 torch.from_numpy(d)).numpy(),
        atol=1e-6, rtol=1e-6)
    shs = torch.from_numpy(sh).transpose(1, 2).contiguous()     # [N, K, 3]
    means = torch.from_numpy(rng.normal(size=(53, 3)).astype(np.float32))
    campos = torch.tensor([0.1, -0.2, 0.3])
    np.testing.assert_allclose(
        tproject.sh_to_color(shs, means, campos,
                             torch.tensor(deg, dtype=torch.int32)).numpy(),
        tproject.sh_to_color(shs, means, campos, deg).numpy(), atol=1e-6,
        rtol=1e-6)


def test_tensor_tangents_project_as_floats():
    cam = t_make_camera(np.eye(3), np.zeros(3), 1.1, 0.7, W, H, device="cpu")
    for tan, fov in ((cam.tanfovx, 1.1), (cam.tanfovy, 0.7)):
        assert tan.shape == () and tan.dtype == torch.float32
        assert float(tan) == float(np.float32(np.tan(np.float32(fov) * 0.5)))
    rng = np.random.default_rng(4)
    n = 80
    means = torch.from_numpy(np.stack([rng.uniform(-2, 2, n),
                                       rng.uniform(-2, 2, n),
                                       rng.uniform(1, 8, n)], 1)
                             .astype(np.float32))
    cov = tproject.build_cov3d(
        torch.from_numpy(rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)))
    outs = [tproject.project_gaussians(means, cov, cam.world_view,
                                       cam.full_proj, tx, ty, W, H)
            for tx, ty in ((cam.tanfovx, cam.tanfovy),
                           (float(cam.tanfovx), float(cam.tanfovy)))]
    for a, b, name in zip(*outs, outs[0]._fields):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fov", [(1.25, 0.7), (0.8, 0.95)])
def test_render_at_other_fields_of_view_matches_jax(fov):
    jpool, deform, hp, tpool, tdeform = _scene(1)
    yaw = np.deg2rad(10.0)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    T = np.array([0.2, -0.1, 0.3])
    rh, rw = 64, 96
    jc = j_make_camera(R, T, *fov, rw, rh, time=0.5)
    tc = t_make_camera(R, T, *fov, rw, rh, time=0.5, device="cpu")
    pipe = JPipe()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = j_render(jc, jpool, deform, hp, pipe, jnp.asarray(bg),
                    jnp.asarray(R_AABB), 3, stage="fine", cfg=R_CFG)
    got = t_render(tc, tpool, tdeform, pipe, torch.from_numpy(bg),
                   torch.from_numpy(R_AABB), 3, stage="fine", cfg=R_CFG)
    for k in ("render", "depth"):
        r_close(got[k], want[k], msg=k)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))
    assert int(got["raster_aux"]["n_pairs"]) > 0


# --------------------------------------------------------------------------
# train/graphs.py without a card
# --------------------------------------------------------------------------

def test_graph_key_holds_what_a_capture_is_specialised_on(jax_state):
    state = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    a = camera(0, 0.3, 0.0, FOVS[0], 1)[1]
    b = camera(1, 0.7, 9.0, FOVS[1], 2)[1]            # pose, time, fov

    def key(step, view, stage="fine", cfg=T_CFG):
        return graphs.graph_key(step, state, view, stage, T_HP, T_OPT,
                                T_PIPE, cfg, SPATIAL_LR_SCALE)

    assert key(ttr.train_step, a) == key(ttr.train_step, b)
    assert key(ttr.train_step, a) != key(ttr.train_step, a, "coarse")
    assert key(ttr.train_step, a) != key(tdp.parallel_train_step, a)
    assert key(ttr.train_step_multicam, [a, b]) != key(
        ttr.train_step_multicam, [a, b, b])
    assert key(ttr.train_step, a) != key(
        ttr.train_step, dataclasses.replace(a, depth_map=None))
    assert key(ttr.train_step, a) != key(
        ttr.train_step, a, cfg=dataclasses.replace(T_CFG, max_visible=128))


def test_load_state_copies_only_what_moved(jax_state):
    static = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    assert graphs.load_state(static, static) is static
    scratch = graphs.clone_state(static)
    for name, t in tckpt.state_tensors(scratch).items():
        mine = tckpt.state_tensors(static)[name]
        assert t.data_ptr() != mine.data_ptr() and torch.equal(t, mine), name
    before = {k: v.data_ptr() for k, v in tckpt.state_tensors(static).items()}
    field = {k: v.clone() for k, v in static.deform.state_dict().items()}
    # new pool rows, moments and statistics, as a densify leaves them; the
    # field is shared
    moved = ttr.opacity_reset_step(static)
    moved = dataclasses.replace(moved, stats=PoolStats.zeros(CAP, "cpu"))
    assert moved.deform is static.deform
    assert not torch.equal(moved.pool.opacity, static.pool.opacity)
    got = graphs.load_state(static, moved)
    assert got is static
    assert {k: v.data_ptr() for k, v in
            tckpt.state_tensors(static).items()} == before
    for name, t in tckpt.state_tensors(moved).items():
        assert torch.equal(tckpt.state_tensors(static)[name], t), name
    for k, v in static.deform.state_dict().items():
        assert torch.equal(v, field[k]), k
    small_pool = dataclasses.replace(
        static, pool=dataclasses.replace(static.pool,
                                         xyz=static.pool.xyz[:-1]))
    with pytest.raises(ValueError, match="pool.xyz"):
        graphs.load_state(static, small_pool)
