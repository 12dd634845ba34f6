"""Port parity of training: the losses, ``expon_lr``, one Adam update and
``train_step`` itself, from one JAX ``TrainState`` carried across with
``weights.train_state_from_numpy``.

The starting state is mid-training: random non-zero Adam moments (so
every update depends on both the moments and the new gradient), count 5,
step 40 and non-zero densification statistics.  The JAX step runs on the
CPU with the jnp compositor (its step donates, so it gets a
``clone_state``); the port's with the plain compositors on CPU tensors.
The hexplane runs in float32 (the bfloat16 planes are held to their own
tolerance in test_torch_grads.py).

Tolerances, after one step: loss and metrics rtol 1e-5; every parameter,
``mu`` and ``nu`` atol 1e-5·max|want| (rtol 1e-4) — Adam divides by
sqrt(nu), so gradient differences at the rasterizer's 2e-5·scale move an
update by about that much of its size; ``count``, ``step``, ``nan_skips``,
``denom`` and ``max_radii2d`` exact; ``xyz_grad_accum`` atol
1e-5·max|want|.  After three steps the parameter and moment tolerance is
1e-4·max|want|: the differences compound through the state.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import PipelineParams as JPipe
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.models.pool import create_from_pcd as j_create_from_pcd
from s3gaussian_tpu.train import losses as jl
from s3gaussian_tpu.train import optim as joptim
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu.train.lr import expon_lr as j_expon_lr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.ops import tile_kernels as ttk
from s3gaussian_tpu_torch.train import losses as tl
from s3gaussian_tpu_torch.train import optim as toptim
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.train.lr import expon_lr as t_expon_lr
from s3gaussian_tpu_torch.weights import _deform_leaves, train_state_from_numpy

import tiny_config
from torch_threads import one_torch_thread  # noqa: F401

H, W = 48, 64
N, CAP = 220, 256
HP_KW = dict(tiny_config.ModelHiddenParams, grid_compute_bf16=False)
AABB = np.array([[6.0, 6.0, 9.0], [-6.0, -6.0, 0.0]], np.float32)
SPATIAL_LR_SCALE = 5.0
# one instance each: the JAX step is jitted with these as static arguments
J_HP, J_OPT, J_PIPE = JHP(**HP_KW), JOpt(), JPipe()
J_CFG = JRasterConfig(max_visible=CAP, pair_budget=1 << 16)
T_HP, T_OPT, T_PIPE = tcfg.ModelHiddenParams(**HP_KW), tcfg.OptimizationParams(), \
    tcfg.PipelineParams()
T_CFG = tcfg.RasterConfig(max_visible=CAP, pair_budget=1 << 16)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


# --------------------------------------------------------------------------
# losses, schedule, Adam
# --------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((3, 40, 52)).astype(np.float32)
    b = rng.random((3, 40, 52)).astype(np.float32)
    d_pred = rng.uniform(0, 90, (40, 52)).astype(np.float32)
    d_gt = rng.uniform(0, 90, (40, 52)).astype(np.float32)
    d_gt[rng.random((40, 52)) < 0.5] = 0.0           # sparse lidar
    cases = {
        "l1": (jl.l1_loss, tl.l1_loss, (a, b)),
        "l2": (jl.l2_loss, tl.l2_loss, (a, b)),
        "ssim": (jl.ssim, tl.ssim, (a, b)),
        "ssim_batched": (jl.ssim, tl.ssim, (a[None], b[None])),
        "psnr": (jl.psnr, tl.psnr, (a, b)),
    }
    for kind in ("l1", "l2", "smooth_l1"):
        cases["depth_" + kind] = (
            lambda p, g, k=kind: jl.depth_loss(p, g, k),
            lambda p, g, k=kind: tl.depth_loss(p, g, k), (d_pred, d_gt))
    for name, (jf, tf, args) in cases.items():
        want_v, want_g = jax.value_and_grad(jf)(*[jnp.asarray(x)
                                                  for x in args])
        x = t(args[0]).requires_grad_(True)
        got_v = tf(x, t(args[1]))
        (got_g,) = torch.autograd.grad(got_v, [x])
        np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-5,
                                   err_msg=name)
        w = np.asarray(want_g)
        np.testing.assert_allclose(got_g.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 30, lr_final=1.6e-6 * 30, lr_delay_mult=0.01,
         max_steps=30_000),
    dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100,
         lr_delay_mult=0.01, max_steps=500),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_matches_jax(kw):
    steps = np.array([-1, 0, 1, 7, 50, 99, 100, 400, 500, 40_000],
                     np.float32)
    want = [float(j_expon_lr(jnp.asarray(s), **kw)) for s in steps]
    got = [float(t_expon_lr(torch.tensor(s), **kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def test_adam_update_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"pool": {"xyz": (50, 3), "opacity": (50, 1)},
              "deform": {"grid.scale0_plane0": (4, 8, 8),
                         "feature_out.0.weight": (16, 8)}}

    def tree(scale=1.0, positive=False):
        out = {g: {k: (rng.normal(size=s) * scale).astype(np.float32)
                   for k, s in d.items()} for g, d in shapes.items()}
        if positive:
            out = {g: {k: np.abs(v) for k, v in d.items()}
                   for g, d in out.items()}
        return out

    params, grads = tree(), tree(1e-2)
    mu, nu = tree(1e-2), tree(1e-4, positive=True)
    lrs = {"xyz": 1e-3, "opacity": 5e-2, "grid": 2e-4, "deformation": 3e-5}
    jstate = joptim.AdamState(mu=jax.tree_util.tree_map(jnp.asarray, mu),
                              nu=jax.tree_util.tree_map(jnp.asarray, nu),
                              count=jnp.asarray(4, jnp.int32))

    def jgroup(path):
        keys = [getattr(p, "key", None) for p in path]
        return keys[1] if keys[0] == "pool" else (
            "grid" if keys[1].startswith("grid.") else "deformation")

    want_p, want_s = joptim.adam_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads), jstate,
        lambda path: jnp.asarray(lrs[jgroup(path)]))

    def tt(x):
        return {g: {k: t(v) for k, v in d.items()} for g, d in x.items()}

    tparams = tt(params)
    state = toptim.AdamState(mu=tt(mu), nu=tt(nu),
                             count=torch.tensor(4, dtype=torch.int32))
    new = toptim.adam_update(
        tparams, tt(grads), state,
        lambda g, k: torch.tensor(lrs[toptim.path_group(g, k)]))
    assert int(new.count) == 5 == int(want_s.count)
    for g, d in shapes.items():
        for k in d:
            for got, want in ((tparams[g][k], want_p[g][k]),
                              (new.mu[g][k], want_s.mu[g][k]),
                              (new.nu[g][k], want_s.nu[g][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=2e-6, atol=1e-9,
                                           err_msg=f"{g}.{k}")


# --------------------------------------------------------------------------
# train_step from one mid-training JAX state
# --------------------------------------------------------------------------

def _cameras(seed, time, feat=False, nan=False):
    rng = np.random.default_rng(seed)
    image = rng.random((H, W, 3)).astype(np.float32)
    if nan:
        image[3, 5, 1] = np.nan
    depth = rng.uniform(1, 12, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.3] = 0.0
    feat_map = rng.normal(size=(H, W, 3)).astype(np.float32) if feat else None
    yaw = np.deg2rad(8.0 * seed)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    T = np.array([0.2, -0.1, 0.3])
    kw = dict(time=time, image=image, depth_map=depth, feat_map=feat_map)
    return (j_make_camera(R, T, 1.0, 0.8, W, H, **kw),
            t_make_camera(R, T, 1.0, 0.8, W, H, device="cpu", **kw))


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState with non-zero moments, count, step and stats."""
    rng = np.random.default_rng(0)
    tan = np.tan(0.45)
    z = rng.uniform(1.5, 8.0, N)
    pts = np.stack([rng.uniform(-0.9, 0.9, N) * tan * z,
                    rng.uniform(-0.9, 0.9, N) * tan * z, z], 1)
    pool = j_create_from_pcd(pts.astype(np.float32),
                             rng.random((N, 3)).astype(np.float32), CAP)
    pool.features_rest = jnp.asarray(
        0.2 * rng.normal(size=pool.features_rest.shape), jnp.float32)
    pool.opacity = jnp.asarray(rng.normal(0.5, 1.0, (CAP, 1)), jnp.float32)
    pool.alive = pool.alive & jnp.asarray(rng.random(CAP) > 0.05)
    deform = init_deformation(jax.random.PRNGKey(1), J_HP)
    return mid_training(jtr.init_state(pool, deform, jnp.asarray(AABB)), rng)


def mid_training(state, rng):
    """A JAX ``state`` with random non-zero Adam moments, count 5, step 40
    and non-zero statistics, drawn from ``rng``."""
    def noise(x, scale, positive=False):
        v = rng.normal(size=x.shape) * scale
        return jnp.asarray(np.abs(v) if positive else v, jnp.float32)

    mu = jax.tree_util.tree_map(lambda x: noise(x, 1e-3), state.adam.mu)
    nu = jax.tree_util.tree_map(lambda x: noise(x, 1e-6, True),
                                state.adam.nu)
    d = state.stats.denom
    stats = jtr.PoolStats(max_radii2d=noise(d, 3.0, True),
                          xyz_grad_accum=noise(d, 1e-3, True),
                          denom=jnp.asarray(rng.integers(0, 9, d.shape),
                                            jnp.float32))
    return dataclasses.replace(
        state, adam=joptim.AdamState(mu=mu, nu=nu,
                                     count=jnp.asarray(5, jnp.int32)),
        stats=stats, step=jnp.asarray(40, jnp.int32))


def _run_both(jstate, cams, stage, sh_degree):
    tstate = train_state_from_numpy(np_tree(jstate), T_HP, device="cpu")
    js = jtr.clone_state(jstate)
    jaux = taux = None
    for jc, tc in cams:
        js, jaux = jtr.train_step(js, jc, stage, sh_degree, J_HP, J_OPT,
                                  J_PIPE, J_CFG, SPATIAL_LR_SCALE,
                                  jnp.zeros(3))
        tstate, taux = ttr.train_step(tstate, tc, stage, sh_degree, T_HP,
                                      T_OPT, T_PIPE, T_CFG, SPATIAL_LR_SCALE,
                                      torch.zeros(3))
    return np_tree(js), jaux, tstate, taux


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * scale,
                               rtol=10 * tol, err_msg=what)


def assert_states_match(ts, js, tol):
    pool = ts.pool.param_dict()
    jpool = js.pool.param_dict()
    for k in pool:
        _close(pool[k], jpool[k], tol, f"pool.{k}")
        _close(ts.adam.mu["pool"][k], js.adam.mu["pool"][k], tol, f"mu.{k}")
        _close(ts.adam.nu["pool"][k], js.adam.nu["pool"][k], tol, f"nu.{k}")
    params = dict(ts.deform.named_parameters())
    for name, path, transpose in _deform_leaves(ts.deform):
        def at(tree):
            for k in path:
                tree = tree[k]
            return np.asarray(tree).T if transpose else np.asarray(tree)
        _close(params[name], at(js.deform), tol, name)
        _close(ts.adam.mu["deform"][name], at(js.adam.mu["deform"]), tol,
               "mu." + name)
        _close(ts.adam.nu["deform"][name], at(js.adam.nu["deform"]), tol,
               "nu." + name)
    for k in ("count",):
        assert int(ts.adam.count) == int(js.adam.count)
    assert int(ts.step) == int(js.step)
    assert int(ts.nan_skips) == int(js.nan_skips)
    np.testing.assert_array_equal(ts.stats.denom.numpy(), js.stats.denom)
    np.testing.assert_array_equal(ts.stats.max_radii2d.numpy(),
                                  js.stats.max_radii2d)
    _close(ts.stats.xyz_grad_accum, js.stats.xyz_grad_accum, 1e-5,
           "xyz_grad_accum")


def assert_aux_match(taux, jaux):
    assert sorted(taux["metrics"]) == sorted(jaux["metrics"])
    for k, v in taux["metrics"].items():
        np.testing.assert_allclose(v.item(), float(jaux["metrics"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(taux[k]) == int(jaux[k]), k
    np.testing.assert_array_equal(taux["radii"].numpy(),
                                  np.asarray(jaux["radii"]))


@pytest.mark.parametrize("stage,n_steps,feat", [
    ("coarse", 1, False),
    ("fine", 1, False),
    ("fine", 3, False),
    ("fine", 1, True),             # + the DINO feature loss (second pass)
])
def test_train_step_matches_jax(jax_state, stage, n_steps, feat):
    cams = [_cameras(i, 0.3 + 0.2 * i, feat=feat) for i in range(n_steps)]
    launches = ttk.launches["composite_bwd"]
    js, jaux, ts, taux = _run_both(jax_state, cams, stage, 3)
    assert ttk.launches["composite_bwd"] == launches    # CPU: no kernel ran
    assert_aux_match(taux, jaux)
    assert ("feat" in taux["metrics"]) == feat
    assert int(taux["n_pairs"]) > 0
    assert_states_match(ts, js, 1e-5 if n_steps == 1 else 1e-4)
    # the step moved every pool group and both field groups
    start = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    for k, v in ts.pool.param_dict().items():
        assert not torch.equal(v, start.pool.param_dict()[k]), k
    for group, params in ts.deform.param_groups().items():
        before = start.deform.param_groups()[group]
        assert any(not torch.equal(p, before[n])
                   for n, p in params.items()), group


def test_nan_watchdog_matches_jax(jax_state):
    """A non-finite loss zeroes the gradients and the learning rates: no
    parameter moves, the moments decay, ``nan_skips`` counts it, and the
    statistics take no NaN."""
    js, jaux, ts, taux = _run_both(jax_state, [_cameras(0, 0.4, nan=True)],
                                   "fine", 3)
    assert not np.isfinite(float(jaux["metrics"]["loss"]))
    assert not np.isfinite(taux["metrics"]["loss"].item())
    assert int(ts.nan_skips) == 1
    start = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    for k, v in ts.pool.param_dict().items():
        torch.testing.assert_close(v, start.pool.param_dict()[k], rtol=0,
                                   atol=0)
    assert torch.isfinite(ts.stats.xyz_grad_accum).all()
    assert_states_match(ts, js, 1e-5)
