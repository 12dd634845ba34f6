"""Port parity of density control: ``densify_and_prune``, ``reset_opacity``,
``densify_schedule``, ``probe_pool`` and the state-level steps, against the
JAX package on the same numpy inputs.

One mid-training pool (some rows dead, log-scales spread across the
clone/split boundary, accumulated gradients around the threshold, screen
radii around 20 px) goes through both packages; the split noise is JAX's
own two draws, passed to the port.  Masks, every ``info`` count, copied
rows and the zeroed moments must be exact; split positions agree to
atol 1e-6·max|xyz| and split scalings to rtol 1e-6 (the rotation of the
noise is a float32 product whose order may differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.models import pool as jpool
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.train import optim as joptim
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.models import pool as tpool
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.weights import train_state_from_numpy

import tiny_config
from torch_index_bounds import IndexBounds
from torch_threads import one_torch_thread  # noqa: F401

CAP = 256
GROUPS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
FIELDS = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
          "scaling": "scaling", "rotation": "rotation", "opacity": "opacity"}


def make_inputs(seed=0, alive_frac=0.6, cap=CAP):
    """numpy pool fields, Adam rows and stats of a mid-training pool."""
    rng = np.random.default_rng(seed)
    alive = rng.random(cap) < alive_frac
    rot = rng.normal(size=(cap, 4)).astype(np.float32)
    rot[~alive] = [1, 0, 0, 0]
    pool = {
        "xyz": rng.normal(0, 4, (cap, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(cap, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(0, 0.2, (cap, 15, 3)).astype(np.float32),
        # max scale from e^-6 to e^0: around 0.01·extent for extent ~ 0.2-10
        "scaling": rng.uniform(-6.0, 0.0, (cap, 3)).astype(np.float32),
        "rotation": rot,
        "opacity": rng.normal(-1.0, 2.5, (cap, 1)).astype(np.float32),
        "alive": alive,
    }
    rows = {g: (rng.normal(0, 1e-3, pool[FIELDS[g]].shape).astype(np.float32),
                np.abs(rng.normal(0, 1e-6, pool[FIELDS[g]].shape)).astype(
                    np.float32)) for g in GROUPS}
    denom = rng.integers(0, 6, cap).astype(np.float32)
    stats = {"max_radii2d": rng.uniform(0, 40, cap).astype(np.float32),
             "xyz_grad_accum": (denom * rng.uniform(0, 4e-4, cap)).astype(
                 np.float32),
             "denom": denom}
    return pool, rows, stats


def run_jax(pool, rows, stats, key, **kw):
    jp = jpool.GaussianPool(**{k: jnp.asarray(v) for k, v in pool.items()})
    jrows = {g: tuple(jnp.asarray(r) for r in v) for g, v in rows.items()}
    js = jpool.PoolStats(**{k: jnp.asarray(v) for k, v in stats.items()})
    out = jpool.densify_and_prune(jp, jrows, js, key, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def jax_noise(key, cap=CAP):
    """The two draws densify_and_prune makes from ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (cap, 3))))
                 for k in (k1, k2))


def run_port(pool, rows, stats, noise, **kw):
    tp = tpool.GaussianPool(**{k: torch.from_numpy(v.copy())
                               for k, v in pool.items()})
    trows = {g: tuple(torch.from_numpy(r.copy()) for r in v)
             for g, v in rows.items()}
    ts = tpool.PoolStats(**{k: torch.from_numpy(v.copy())
                            for k, v in stats.items()})
    return tpool.densify_and_prune(tp, trows, ts, noise, **kw)


def assert_densify_matches(got, want, before):
    tp, trows, tstats, tinfo = got
    jp, jrows, jstats, jinfo = want
    assert sorted(tinfo) == sorted(jinfo)
    for k, v in jinfo.items():
        assert int(tinfo[k]) == int(v), k
    np.testing.assert_array_equal(tp.alive.numpy(), jp.alive)
    split_rows = np.zeros(CAP, bool)
    for g in GROUPS:
        got_v = getattr(tp, FIELDS[g]).numpy()
        want_v = getattr(jp, FIELDS[g])
        if g == "xyz":
            np.testing.assert_allclose(
                got_v, want_v, rtol=0,
                atol=1e-6 * np.abs(before["xyz"]).max(), err_msg=g)
            split_rows = (got_v != before["xyz"]).any(1)
        elif g == "scaling":
            np.testing.assert_allclose(got_v, want_v, rtol=1e-6, err_msg=g)
        else:
            np.testing.assert_array_equal(got_v, want_v, err_msg=g)
        for got_r, want_r in zip(trows[g], jrows[g]):
            np.testing.assert_array_equal(got_r.numpy(), want_r, err_msg=g)
    # rows that no split wrote are copied, not recomputed
    same = ~split_rows
    for g in ("xyz", "scaling"):
        np.testing.assert_array_equal(getattr(tp, FIELDS[g]).numpy()[same],
                                      getattr(jp, FIELDS[g])[same])
    for f in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(tstats, f).any()


BASE = dict(grad_threshold=2e-4, opacity_threshold=0.005, scene_extent=1.0,
            percent_dense=0.01, max_screen_size=None, max_points=2_000_000)
CASES = {
    "mixed": {},
    "clone_only": dict(scene_extent=1e4),
    "split_only": dict(scene_extent=1e-4),
    "opacity_prune": dict(grad_threshold=1e30, opacity_threshold=0.3),
    "screen_prune": dict(grad_threshold=1e30, max_screen_size=20.0,
                         scene_extent=1e3),
    "world_prune": dict(grad_threshold=1e30, world_prune=True,
                        scene_extent=5.0),
    "size_prune_cap": dict(max_screen_size=20.0, size_prune_cap=0.05,
                           scene_extent=3.0),
    "exhausted": dict(grad_threshold=1e-5, alive_frac=0.93),
    "at_max_points": dict(max_points=100, opacity_threshold=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_and_prune_matches_jax(case):
    kw = dict(BASE, **CASES[case])
    alive_frac = kw.pop("alive_frac", 0.6)
    pool, rows, stats = make_inputs(seed=sorted(CASES).index(case),
                                    alive_frac=alive_frac)
    key = jax.random.PRNGKey(7)
    want = run_jax(pool, rows, stats, key, **kw)
    got = run_port(pool, rows, stats, jax_noise(key), **kw)
    assert_densify_matches(got, want, pool)
    info = {k: int(v) for k, v in want[3].items()}
    # each case does what its name says
    expect = {
        "mixed": info["n_cloned"] > 0 and info["n_split"] > 0
        and info["n_pruned"] > 0,
        "clone_only": info["n_cloned"] > 0 and info["n_split"] == 0,
        "split_only": info["n_split"] > 0 and info["n_cloned"] == 0,
        "opacity_prune": info["n_prune_opacity"] > 0
        and info["n_cloned"] + info["n_split"] == 0,
        "screen_prune": info["n_prune_screen"] > 0
        and info["n_prune_world"] == 0,
        "world_prune": info["n_prune_world"] > 0
        and info["n_prune_screen"] == 0,
        "size_prune_cap": info["n_prune_size_capped"] > 0,
        "exhausted": info["overflow"] > 0,
        "at_max_points": info["n_cloned"] + info["n_split"] == 0
        and info["n_pruned"] > 0,
    }[case]
    assert expect, info


@pytest.mark.parametrize("case", ["mixed", "exhausted", "size_prune_cap"])
def test_densify_indices_stay_in_range(case):
    """No index reaches an indexing operator outside [0, Nc): the JAX
    package's dropped sentinel Nc has no counterpart here."""
    kw = dict(BASE, **CASES[case])
    pool, rows, stats = make_inputs(seed=1, alive_frac=kw.pop("alive_frac",
                                                               0.6))
    noise = jax_noise(jax.random.PRNGKey(1))
    with IndexBounds() as bounds:
        _, _, _, info = run_port(pool, rows, stats, noise, **kw)
    bounds.assert_within(CAP)
    assert int(info["n_cloned"]) + int(info["n_split"]) > 0


def test_reset_opacity_matches_jax():
    pool, rows, _ = make_inputs(3)
    jp = jpool.GaussianPool(**{k: jnp.asarray(v) for k, v in pool.items()})
    jpo, jrows = jax.tree_util.tree_map(np.asarray, jpool.reset_opacity(
        jp, {g: tuple(jnp.asarray(r) for r in v) for g, v in rows.items()}))
    tp = tpool.GaussianPool(**{k: torch.from_numpy(v.copy())
                               for k, v in pool.items()})
    tpo, trows = tpool.reset_opacity(
        tp, {g: tuple(torch.from_numpy(r.copy()) for r in v)
             for g, v in rows.items()})
    for f in FIELDS.values():
        np.testing.assert_array_equal(getattr(tpo, f).numpy(),
                                      getattr(jpo, f), err_msg=f)
    for g in GROUPS:
        for a, b in zip(trows[g], jrows[g]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=g)
    assert not trows["opacity"][0].any()
    assert (tpo.opacity.numpy() <= np.log(0.01 / 0.99) + 1e-6).all()


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_densify_schedule_matches_jax(stage):
    kw = dict(densify_until_iter=1000, opacity_threshold_fine_init=0.005,
              opacity_threshold_fine_after=0.05,
              densify_grad_threshold_fine_init=2e-4,
              densify_grad_threshold_after=5e-5)
    jopt, topt = JOpt(**kw), tcfg.OptimizationParams(**kw)
    for it in (0, 1, 250, 999, 1000, 1500, 40_000):     # past the end: clamped
        assert ttr.densify_schedule(it, stage, topt) == \
            jtr.densify_schedule(it, stage, jopt)


HP_KW = dict(tiny_config.ModelHiddenParams, grid_compute_bf16=False)


@pytest.fixture(scope="module")
def jax_state():
    pool, rows, stats = make_inputs(5)
    jhp = JHP(**HP_KW)
    jp = jpool.GaussianPool(**{k: jnp.asarray(v) for k, v in pool.items()})
    state = jtr.init_state(jp, init_deformation(jax.random.PRNGKey(2), jhp),
                           jnp.asarray([[6.0] * 3, [-6.0] * 3]))
    rng = np.random.default_rng(9)

    def noise(x, scale, positive=False):
        v = rng.normal(size=x.shape) * scale
        return jnp.asarray(np.abs(v) if positive else v, jnp.float32)

    mu = jax.tree_util.tree_map(lambda x: noise(x, 1e-3), state.adam.mu)
    nu = jax.tree_util.tree_map(lambda x: noise(x, 1e-6, True), state.adam.nu)
    return dataclasses.replace(
        state, adam=joptim.AdamState(mu=mu, nu=nu,
                                     count=jnp.asarray(7, jnp.int32)),
        stats=jpool.PoolStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
        step=jnp.asarray(120, jnp.int32))


def to_port(jstate):
    return train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                  tcfg.ModelHiddenParams(**HP_KW),
                                  device="cpu")


def test_probe_pool_matches_jax(jax_state):
    want = jtr.probe_pool(jax_state, JOpt(), 5.0)
    got = ttr.probe_pool(to_port(jax_state), tcfg.OptimizationParams(), 5.0)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_densify_step_edits_the_state_like_jax(jax_state):
    """The state-level step: pool and pool moments as densify_and_prune
    gives them for the generator's draws, the field's moments, count,
    step and aabb untouched, statistics zeroed."""
    key = jax.random.PRNGKey(3)
    jnew, jinfo = jtr.densify_step(jax_state, key, 2e-4, 0.005, 1.0, 20.0,
                                   JOpt())
    start = to_port(jax_state)
    gen = torch.Generator().manual_seed(11)
    tnew, tinfo = ttr.densify_step(start, gen, 2e-4, 0.005, 1.0, 20.0,
                                   tcfg.OptimizationParams())
    # the counts do not depend on the noise
    for k, v in jinfo.items():
        assert int(tinfo[k]) == int(v), k
    noise = torch.randn((2, CAP, 3), generator=torch.Generator().manual_seed(11))
    pool, rows, _, _ = tpool.densify_and_prune(
        to_port(jax_state).pool,
        {g: (start.adam.mu["pool"][g], start.adam.nu["pool"][g])
         for g in GROUPS}, start.stats, (noise[0], noise[1]), 2e-4, 0.005, 1.0,
        0.01, 20.0, 2_000_000)
    np.testing.assert_array_equal(tnew.pool.alive.numpy(),
                                  np.asarray(jnew.pool.alive))
    for g in GROUPS:
        torch.testing.assert_close(tnew.pool.param_dict()[g],
                                   pool.param_dict()[g], rtol=0, atol=0)
        torch.testing.assert_close(tnew.adam.mu["pool"][g], rows[g][0],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(tnew.adam.nu["pool"][g].numpy(),
                                      np.asarray(jnew.adam.nu["pool"][g]))
    for name, v in start.adam.mu["deform"].items():
        assert tnew.adam.mu["deform"][name] is v
    assert int(tnew.adam.count) == 7 and int(tnew.step) == 120
    assert not tnew.stats.denom.any() and not tnew.stats.max_radii2d.any()


def test_opacity_reset_step_matches_jax(jax_state):
    jnew = jax.tree_util.tree_map(np.asarray,
                                  jtr.opacity_reset_step(jax_state))
    tnew = ttr.opacity_reset_step(to_port(jax_state))
    np.testing.assert_array_equal(tnew.pool.opacity.numpy(),
                                  jnew.pool.opacity)
    for g in GROUPS:
        np.testing.assert_array_equal(tnew.adam.mu["pool"][g].numpy(),
                                      jnew.adam.mu["pool"][g])
    np.testing.assert_array_equal(tnew.stats.denom.numpy(), jnew.stats.denom)
