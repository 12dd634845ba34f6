"""Port parity of the pre-deformation cull (``cull_before_deform``):
``ops/compact.py::take_compact`` and the culled fine-stage losses of
``render`` and of the rig's ``render_multicam`` (the union cull).

  * ``take_compact``: the candidates, the forward gather and the rank
    backward equal JAX's exactly, and the backward runs no scatter
    (no ``index_put_``, ``scatter`` or ``index_add``);
  * the culled losses from one mid-training pool with a third of its
    points behind the cameras (``test_torch_train.py``'s state): the
    single camera with a budget below its cull's count, so the
    visible-first order decides the working set, and a yawed 3-camera
    rig with per-camera taps.  Metrics rtol 1e-5; every gradient (pool
    rows, field, tap) atol 2e-5·max|want| rtol 2e-4, the rasterizer's
    tolerances; radii, visibility, ``vis_count`` and the counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import stack_cameras
from s3gaussian_tpu.ops.compact import take_compact as j_take_compact
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.ops import compact as tcompact
from s3gaussian_tpu_torch.render import renderer
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.weights import _deform_leaves, train_state_from_numpy

from test_torch_multicam import rig
from test_torch_train import (CAP, J_HP, J_PIPE, T_HP, T_PIPE, jax_state,
                              np_tree)
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["jax_state"]


class OpLog(TorchDispatchMode):
    """The ATen ops run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("nr", [20, 64])
@pytest.mark.parametrize("shape", [(3,), (1, 3)])
def test_take_compact_matches_jax(nr, shape):
    rng = np.random.default_rng(nr)
    n = 80
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    vis = rng.random(n) < 0.6
    g = rng.normal(size=(nr,) + shape).astype(np.float32)
    jvis = jnp.asarray(vis)
    _, order = jax.lax.sort((jnp.where(jvis, jnp.uint32(0), jnp.uint32(1)),
                             jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    jcand = order[:nr]
    want, vjp = jax.vjp(lambda a: j_take_compact(a, jcand, jvis),
                        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))

    tvis = torch.from_numpy(vis)
    cand = tcompact.candidates(tvis, nr)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tcompact.take_compact(xt, cand, tvis)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    with OpLog() as log:
        (got_g,) = torch.autograd.grad(got, [xt], torch.from_numpy(g))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert not [op for op in log.ops
                if "index_put" in op or "scatter" in op or "index_add" in op]
    assert any("cumsum" in op for op in log.ops)


def culled_state(jstate):
    """The mid-training JAX state with every third point behind the
    cameras (z = -5)."""
    pool = jstate.pool
    return dataclasses.replace(jstate, pool=dataclasses.replace(
        pool, xyz=pool.xyz.at[::3, 2].set(-5.0)))


def jax_loss_grads(jstate, cams, cfg, percam):
    """JAX's culled loss, aux and gradients (params, tap) of one camera
    (``compute_loss``) or a rig (``compute_loss_multicam``)."""
    params = {"pool": jstate.pool.param_dict(), "deform": jstate.deform}
    multi = len(cams) > 1
    tap = jnp.zeros(((len(cams),) if percam else ()) + (CAP, 2))
    if multi:
        def fn(p, tp):
            return jtr.compute_loss_multicam(
                p, tp, jstate.pool.alive, stack_cameras([c[0] for c in cams]),
                len(cams), "fine", 3, J_HP, JOpt(), J_PIPE, jstate.aabb,
                jnp.zeros(3), cfg)
    else:
        def fn(p, tp):
            return jtr.compute_loss(p, tp, jstate.pool.alive, cams[0][0],
                                    "fine", 3, J_HP, JOpt(), J_PIPE,
                                    jstate.aabb, jnp.zeros(3), cfg)
    (loss, aux), (g, gtap) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(params, tap)
    return loss, aux, np_tree(g), np.asarray(gtap)


def assert_grads_match(tgrads, ttap, jgrads, jtap, deform):
    def close(got, want, what):
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale,
                                   rtol=2e-4, err_msg=what)

    for k, v in tgrads["pool"].items():
        close(v, jgrads["pool"][k], f"pool.{k}")
    for name, path, transpose in _deform_leaves(deform):
        want = jgrads["deform"]
        for k in path:
            want = want[k]
        close(tgrads["deform"][name], want.T if transpose else want, name)
    close(ttap, jtap, "tap")
    assert np.abs(jtap).max() > 0


@pytest.mark.parametrize("case", ["camera_budget_128", "rig3_union"])
def test_culled_loss_and_gradients_match_jax(jax_state, case):
    jstate = culled_state(jax_state)
    if case == "camera_budget_128":
        cams, nr = rig(0.4, yaws=(0.0,), shifts=(0.0,)), 128
    else:
        cams, nr = rig(0.6, yaws=(0.0, 20.0, -20.0)), CAP
    kw = dict(max_visible=nr, pair_budget=1 << 16, cull_before_deform=True,
              cull_margin_px=8.0)
    jloss, jaux, jg, jtap = jax_loss_grads(jstate, cams, JRasterConfig(**kw),
                                           percam=len(cams) > 1)

    tstate = train_state_from_numpy(np_tree(jstate), T_HP, device="cpu")
    camera = [c[1] for c in cams] if len(cams) > 1 else cams[0][1]
    loss, aux, tree, tap = ttr.step_forward(
        tstate, camera, "fine", 3, T_HP, tcfg.OptimizationParams(), T_PIPE,
        tcfg.RasterConfig(**kw), torch.zeros(3))
    grads, tap_grad = ttr.step_gradients(loss, tree, tap)

    for k, v in aux["metrics"].items():
        np.testing.assert_allclose(v.item(), float(jaux["metrics"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    keys = ("radii", "visible") + (("vis_count",) if len(cams) > 1 else ())
    for k in keys:
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(aux[k]) == int(jaux[k]), k
    assert_grads_match(grads, tap_grad, jg, jtap, tstate.deform)
    # the cull drew fewer rows than the pool holds, none behind the camera
    n_vis0 = int(aux["visible"].sum())
    assert 0 < n_vis0 < int(tstate.pool.alive.sum())
    assert not aux["visible"][::3].any()
    # the single camera's budget truncates its candidates
    _, vis0, _ = renderer.cull_working_set(tstate.pool, [c[1] for c in cams],
                                           tcfg.RasterConfig(**kw))
    assert (int(vis0.sum()) > nr) == (case == "camera_budget_128")
