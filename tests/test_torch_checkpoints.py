"""The port's checkpoints and PLY export against the JAX package's: PLY
files byte for byte, ``load_ply_pool``, a bit-exact save/load round trip
of the whole train state (Adam moments and statistics included), the
deletion of older checkpoints only after the new one is on disk, fine
outranking coarse, and the deformation transplant across capacities."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.models import pool as jpool
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.train import checkpoints as jckpt
from s3gaussian_tpu.train import optim as joptim
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.train import checkpoints as tckpt
from s3gaussian_tpu_torch.weights import pool_from_numpy, train_state_from_numpy

import tiny_config
from torch_threads import one_torch_thread  # noqa: F401

HP_KW = dict(tiny_config.ModelHiddenParams, grid_compute_bf16=False)


def jax_pool(seed=0, n=40, cap=64):
    """A JAX pool with every field away from its init value and a few
    rows killed."""
    rng = np.random.default_rng(seed)
    p = jpool.create_from_pcd(rng.normal(size=(n, 3)).astype(np.float32),
                              rng.random((n, 3)).astype(np.float32), cap)
    alive = np.asarray(p.alive).copy()
    alive[[3, 17, 21]] = False

    def rand(x, scale=1.0):
        return jnp.asarray(rng.normal(0, scale, x.shape).astype(np.float32))

    return jpool.GaussianPool(
        xyz=p.xyz, features_dc=rand(p.features_dc),
        features_rest=rand(p.features_rest, 0.1),
        scaling=rand(p.scaling) - 3.0, rotation=rand(p.rotation),
        opacity=rand(p.opacity, 2.0), alive=jnp.asarray(alive))


def to_port_pool(jp):
    return pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, jp)),
                           device="cpu")


def test_ply_bytes_identical_to_jax(tmp_path):
    jp = jax_pool()
    jckpt.save_ply_pool(str(tmp_path / "j" / "p.ply"), jp)
    tckpt.save_ply_pool(str(tmp_path / "t" / "p.ply"), to_port_pool(jp))
    want = (tmp_path / "j" / "p.ply").read_bytes()
    assert (tmp_path / "t" / "p.ply").read_bytes() == want
    assert b"element vertex 37\n" in want


def test_ply_split_bytes_identical_to_jax(tmp_path):
    jp = jax_pool(1)
    dx = np.random.default_rng(2).normal(0, 0.05, (64, 3)).astype(np.float32)
    dx[:6] += 1.5
    jmask = jckpt.save_ply_split(str(tmp_path / "jd.ply"),
                                 str(tmp_path / "js.ply"), jp, dx)
    tmask = tckpt.save_ply_split(str(tmp_path / "td.ply"),
                                 str(tmp_path / "ts.ply"), to_port_pool(jp),
                                 torch.from_numpy(dx))
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < tmask.sum() < 37
    for kind in ("d", "s"):
        assert (tmp_path / f"t{kind}.ply").read_bytes() == \
            (tmp_path / f"j{kind}.ply").read_bytes()


@pytest.mark.parametrize("capacity", [None, 64])
def test_load_ply_pool_matches_jax(tmp_path, capacity):
    path = str(tmp_path / "p.ply")
    jckpt.save_ply_pool(path, jax_pool(3))
    got = tckpt.load_ply_pool(path, capacity, device="cpu")
    want = jckpt.load_ply_pool(path, capacity)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.capacity == (capacity or 2048)
    with pytest.raises(ValueError, match="capacity"):
        tckpt.load_ply_pool(path, 16, device="cpu")


def port_state(seed, cap=64, step=120):
    """A port train state from a JAX mid-training one: non-zero moments,
    statistics, step and watchdog count."""
    rng = np.random.default_rng(seed)
    state = jtr.init_state(jax_pool(seed, cap=cap),
                           init_deformation(jax.random.PRNGKey(seed),
                                            JHP(**HP_KW)),
                           jnp.asarray([[6.0] * 3, [-6.0] * 3]))

    def noise(x, scale, positive=False):
        v = rng.normal(size=x.shape) * scale
        return jnp.asarray(np.abs(v) if positive else v, jnp.float32)

    state = dataclasses.replace(
        state,
        adam=joptim.AdamState(
            mu=jax.tree_util.tree_map(lambda x: noise(x, 1e-3), state.adam.mu),
            nu=jax.tree_util.tree_map(lambda x: noise(x, 1e-6, True),
                                      state.adam.nu),
            count=jnp.asarray(step + 3, jnp.int32)),
        stats=jpool.PoolStats(*(noise(state.stats.denom, 5.0, True)
                                for _ in range(3))),
        step=jnp.asarray(step, jnp.int32),
        nan_skips=jnp.asarray(2, jnp.int32))
    return train_state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                  tcfg.ModelHiddenParams(**HP_KW),
                                  device="cpu")


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    state = port_state(0)
    path = tckpt.save_checkpoint(str(tmp_path), "fine", 120, state)
    assert open(os.path.join(path, "STAGE")).read() == "fine 120"
    flat = torch.load(os.path.join(path, tckpt.STATE_FILE), weights_only=True)
    want = tckpt.state_tensors(state)
    assert sorted(flat) == sorted(want)
    assert any(k.startswith("adam.mu.deform.") for k in flat)

    loaded, stage, it = tckpt.load_checkpoint(path, port_state(1))
    assert (stage, it) == ("fine", 120)
    got = tckpt.state_tensors(loaded)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    # the loaded moments pair with the loaded field's parameters by name
    assert set(loaded.adam.mu["deform"]) == \
        {n for n, _ in loaded.deform.named_parameters()}


def test_load_refuses_another_capacity(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), "coarse", 5, port_state(0))
    with pytest.raises(ValueError, match="pool.xyz"):
        tckpt.load_checkpoint(path, port_state(1, cap=128))


def test_older_checkpoints_go_only_after_the_new_one_is_saved(tmp_path,
                                                              monkeypatch):
    state = port_state(0)
    tckpt.save_checkpoint(str(tmp_path), "coarse", 5, state)
    tckpt.save_checkpoint(str(tmp_path), "coarse", 10, state)
    assert sorted(os.listdir(tmp_path)) == ["chkpnt_coarse_10"]

    def failing_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_checkpoint(str(tmp_path), "fine", 20, state)
    # the cut save left nothing that looks like a checkpoint, and the old
    # one is still there to resume from
    assert tckpt.find_checkpoint(str(tmp_path))[1:] == ("coarse", 10)
    monkeypatch.undo()
    tckpt.save_checkpoint(str(tmp_path), "fine", 20, state)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("chkpnt_")) \
        == ["chkpnt_fine_20"]


def test_find_checkpoint_fine_outranks_coarse(tmp_path):
    state = port_state(0)
    assert tckpt.find_checkpoint(str(tmp_path / "none")) is None
    for stage, it in (("coarse", 5000), ("fine", 3000), ("fine", 700)):
        tckpt.save_checkpoint(str(tmp_path), stage, it, state,
                              keep_others=True)
    path, stage, it = tckpt.find_checkpoint(str(tmp_path))
    assert (stage, it) == ("fine", 3000)
    assert path == os.path.join(str(tmp_path), "chkpnt_fine_3000")


def test_transplant_moves_only_the_field_across_capacities(tmp_path):
    prior = port_state(0, cap=64)
    path = tckpt.save_checkpoint(str(tmp_path), "fine", 9, prior)
    fresh = port_state(4, cap=128, step=0)
    pool_before = {k: v.clone() for k, v in fresh.pool.param_dict().items()}
    warm = tckpt.transplant_deformation(path, fresh)
    assert warm.pool.capacity == 128
    for k, v in prior.deform.state_dict().items():
        assert torch.equal(warm.deform.state_dict()[k], v), k
    for k, v in pool_before.items():
        assert torch.equal(warm.pool.param_dict()[k], v), k
    assert int(warm.step) == 0
