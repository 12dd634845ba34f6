"""Port parity of the rig train step (``train_step_multicam``): one field
evaluation for B same-time cameras, the losses pooled over the stacked
renders, the per-camera screen-gradient statistics and
``multicam_lr_scale``.

  * B=1 equals the single-camera step within the port: loss rtol 1e-6,
    gradients rtol 2e-5 atol 1e-7, radii equal (``tests/test_multicam.py``'s
    tolerances);
  * the port's and the JAX package's rig steps from one mid-training
    state (``test_torch_train.py``'s: non-zero moments, count 5, step
    40, non-zero statistics): a yawed B=3 rig in the fine stage with the
    DINO feature pass and per-camera statistics, and a shifted B=2 rig in
    the coarse stage with ``multicam_percam_stats`` 0 and
    ``multicam_lr_scale`` 0.5.  The JAX side compiles its rig loop as
    one scan body (``multicam_scan``; ``tests/test_multicam.py`` holds it
    to the unrolled loop), which compiles faster than the unrolled loop
    the port follows.  Tolerances are ``test_torch_train.py``'s: metrics rtol 1e-5;
    parameters, ``mu`` and ``nu`` atol 1e-5·max|want| rtol 1e-4;
    ``denom`` and ``max_radii2d`` exact; ``xyz_grad_accum``
    1e-5·max|want|; radii, visibility and ``vis_count`` exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.data.cameras import stack_cameras
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.ops import tile_kernels as ttk
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.weights import train_state_from_numpy

from test_torch_train import (CAP, H, J_HP, J_PIPE, SPATIAL_LR_SCALE, T_HP,
                              T_PIPE, W, assert_aux_match,
                              assert_states_match, jax_state, np_tree)
from torch_threads import one_torch_thread  # noqa: F401

J_CFG = JRasterConfig(max_visible=CAP, pair_budget=1 << 16,
                      multicam_scan=True)
T_CFG = tcfg.RasterConfig(max_visible=CAP, pair_budget=1 << 16)

__all__ = ["jax_state"]


def rig(time, yaws=(0.0, 8.0, -8.0), shifts=(0.0, 0.0, 0.0), seed=0,
        feat=False):
    """[(JAX camera, port camera)] of one rig at ``time``: each camera
    yawed (degrees) and shifted along x, with its own random image,
    LiDAR-like depth and, with ``feat``, feature map."""
    out = []
    for b, (yaw_deg, dx) in enumerate(zip(yaws, shifts)):
        rng = np.random.default_rng(100 * seed + b)
        image = rng.random((H, W, 3)).astype(np.float32)
        depth = rng.uniform(1, 12, (H, W)).astype(np.float32)
        depth[rng.random((H, W)) < 0.3] = 0.0
        feat_map = (rng.normal(size=(H, W, 3)).astype(np.float32) if feat
                    else None)
        yaw = np.deg2rad(yaw_deg)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        T = np.array([0.2 + dx, -0.1, 0.3])
        kw = dict(time=time, image=image, depth_map=depth, feat_map=feat_map)
        out.append((j_make_camera(R, T, 1.0, 0.8, W, H, **kw),
                    t_make_camera(R, T, 1.0, 0.8, W, H, device="cpu", **kw)))
    return out


def run_rig_both(jstate, cams, stage, opt_kw=(), j_cfg=J_CFG, t_cfg=T_CFG):
    """One rig step of each package from ``jstate``: (JAX state as numpy,
    JAX aux, port state, port aux)."""
    opt_kw = dict(opt_kw)
    tstate = train_state_from_numpy(np_tree(jstate), T_HP, device="cpu")
    js, jaux = jtr.train_step_multicam(
        jtr.clone_state(jstate), stack_cameras([c[0] for c in cams]),
        len(cams), stage, 3, J_HP, JOpt(**opt_kw), J_PIPE, j_cfg,
        SPATIAL_LR_SCALE, jnp.zeros(3))
    ts, taux = ttr.train_step_multicam(
        tstate, [c[1] for c in cams], stage, 3, T_HP,
        tcfg.OptimizationParams(**opt_kw), T_PIPE, t_cfg, SPATIAL_LR_SCALE,
        torch.zeros(3))
    return np_tree(js), jaux, ts, taux


def assert_rig_aux_match(taux, jaux):
    assert_aux_match(taux, jaux)
    for k in ("visible", "vis_count"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)


# (stage, rig, option overrides): a yawed B=3 rig in the fine stage with
# the feature pass and per-camera statistics; a shifted B=2 rig in the
# coarse stage with summed statistics and half the learning rates
RIG_CASES = {
    "fine_yawed3_feat": ("fine", dict(time=0.4, feat=True), {}),
    "coarse_shifted2_summed_lr05": (
        "coarse", dict(time=0.7, yaws=(0.0, 0.0), shifts=(0.0, 0.25), seed=1),
        dict(multicam_percam_stats=0, multicam_lr_scale=0.5)),
}


@pytest.mark.parametrize("case", sorted(RIG_CASES))
def test_rig_step_matches_jax(jax_state, case):
    stage, rig_kw, opt_kw = RIG_CASES[case]
    cams = rig(**rig_kw)
    launches = ttk.launches["composite_bwd"]
    js, jaux, ts, taux = run_rig_both(jax_state, cams, stage, opt_kw)
    assert ttk.launches["composite_bwd"] == launches    # CPU: no kernel ran
    assert_rig_aux_match(taux, jaux)
    assert ("feat" in taux["metrics"]) == rig_kw.get("feat", False)
    assert int(taux["vis_count"].max()) == len(cams)
    assert_states_match(ts, js, 1e-5)
    start = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    inc = (ts.stats.denom - start.stats.denom).numpy()
    if opt_kw.get("multicam_percam_stats", 1):
        # per-camera statistics: the denominator counts the cameras
        np.testing.assert_array_equal(inc, taux["vis_count"].numpy())
    else:
        # summed: every visible Gaussian counts once a step
        np.testing.assert_array_equal(
            inc, taux["visible"].numpy().astype(np.float32))


def test_b1_rig_equals_the_single_step(jax_state):
    state = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    (_, cam), = rig(0.3, yaws=(5.0,), shifts=(0.0,))
    opt = tcfg.OptimizationParams()
    out = {}
    for key, camera in (("one", cam), ("rig", [cam])):
        loss, aux, tree, tap = ttr.step_forward(state, camera, "fine", 3, T_HP,
                                                opt, T_PIPE, T_CFG,
                                                torch.zeros(3))
        grads, tap_grad = ttr.step_gradients(loss, tree, tap)
        out[key] = (loss, aux, grads, tap_grad)
    (l1, a1, g1, t1), (lb, ab, gb, tb) = out["one"], out["rig"]
    assert tb.shape == (1,) + tuple(t1.shape)
    np.testing.assert_allclose(lb.item(), l1.item(), rtol=1e-6)
    for group in g1:
        for k, v in g1[group].items():
            np.testing.assert_allclose(gb[group][k].numpy(), v.numpy(),
                                       rtol=2e-5, atol=1e-7,
                                       err_msg=f"{group}.{k}")
    np.testing.assert_allclose(tb[0].numpy(), t1.numpy(), rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(ab["radii"].numpy(), a1["radii"].numpy())
    np.testing.assert_array_equal(ab["vis_count"].numpy(),
                                  a1["visible"].numpy().astype(np.float32))


def test_rig_step_descends_on_a_fixed_rig(jax_state):
    """Three rig steps on one rig lower its loss and skip no update."""
    state = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    cams = [c[1] for c in rig(0.5, seed=2)]
    opt = dataclasses.replace(tcfg.OptimizationParams(), lambda_dssim=0.0)
    losses = []
    for _ in range(3):
        state, aux = ttr.train_step_multicam(state, cams, "coarse", 0, T_HP,
                                             opt, T_PIPE, T_CFG, 1.0,
                                             torch.zeros(3))
        losses.append(aux["metrics"]["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(state.nan_skips) == 0 and int(state.step) == 43
