"""Port parity of data parallelism: ``parallel/data_parallel.py``'s steps on
two gloo ranks against the JAX package's ``make_parallel_train_step``,
``make_parallel_train_step_multicam`` and ``make_parallel_train_steps_scan``
on two of the conftest's virtual CPU devices.

The port's ranks are two subprocesses, each this file run as a script: a
``file://`` store under ``tmp_path``, the starting state read from an
``.npz`` the parent wrote (``test_torch_train.py``'s mid-training state:
non-zero moments, count 5, step 40) through
``weights.train_state_from_numpy``, every case run in turn from it, and
each rank's final state and aux written back.  After every step each rank
reduces ``replica_checksum`` with MIN and MAX, which must agree.  Cases:

  * single-camera DP, fine, distinct yawed cameras, per-camera statistics
    on, 3 steps;
  * the same in the coarse stage with ``multicam_percam_stats`` 0 (the
    summed-vector branch);
  * rig DP, a rig of 2 same-time cameras a rank, fine, 2 steps;
  * the fine case's 3 steps against one JAX scanned block of 3
    (``make_parallel_train_steps_scan``): a scanned block is that many
    steps, so the scanned variants need no port;
  * a NaN pixel on rank 1 only: both ranks skip the step (the NaN
    watchdog reads the reduced loss), ``nan_skips`` counts it on both;
  * world size 1 (a gloo group in this process): ``parallel_train_step``
    and ``parallel_train_step_multicam`` equal the port's own
    ``train_step`` / ``train_step_multicam`` bit for bit.

Tolerances are ``test_torch_train.py``'s: metrics rtol 1e-5; parameters,
``mu`` and ``nu`` atol 1e-5·max|want| rtol 1e-4 after one step, 1e-4·max
after two or more; ``count``, ``step``, ``nan_skips``, ``denom`` and
``max_radii2d`` exact; the budget counters exact.  The two ranks' final
states are bit-equal.
"""

import os
import re
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.data.cameras import stack_cameras
from s3gaussian_tpu.parallel import data_parallel as jdp
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.parallel import data_parallel as tdp
from s3gaussian_tpu_torch.parallel.multihost import init_multihost
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.train.checkpoints import state_tensors
from s3gaussian_tpu_torch.weights import train_state_from_numpy

from test_torch_train import (CAP, H, J_HP, J_PIPE, SPATIAL_LR_SCALE, T_HP,
                              T_PIPE, W, assert_states_match, jax_state,
                              np_tree)
from torch_ranks import WORLD, Ranks
from torch_threads import one_torch_thread  # noqa: F401

J_CFG = JRasterConfig(max_visible=CAP, pair_budget=1 << 16,
                      multicam_scan=True)
T_CFG = tcfg.RasterConfig(max_visible=CAP, pair_budget=1 << 16)

__all__ = ["jax_state"]


# --------------------------------------------------------------------------
# the cases: per step, per rank, the camera specs (seed, time, yaw, nan)
# --------------------------------------------------------------------------

def view(seed, time, yaw, nan=False):
    """numpy inputs of one camera: (R, T, keyword arguments)."""
    rng = np.random.default_rng(seed)
    image = rng.random((H, W, 3)).astype(np.float32)
    if nan:
        image[3, 5, 1] = np.nan
    depth = rng.uniform(1, 12, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.3] = 0.0
    a = np.deg2rad(yaw)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    return R, np.array([0.2, -0.1, 0.3]), dict(time=time, image=image,
                                                depth_map=depth)


def j_cam(spec):
    R, T, kw = view(*spec)
    return j_make_camera(R, T, 1.0, 0.8, W, H, **kw)


def t_cam(spec):
    R, T, kw = view(*spec)
    return t_make_camera(R, T, 1.0, 0.8, W, H, device="cpu", **kw)


def single_steps(n, nan_rank=None):
    """n steps of one camera a rank: rank r yawed ±8°, its own image."""
    return [[[(10 * s + r, 0.3 + 0.2 * s, 8.0 * (2 * r - 1),
               r == nan_rank)] for r in range(WORLD)] for s in range(n)]


def rig_steps(n):
    """n steps of a rig of 2 same-time cameras a rank."""
    return [[[(100 * s + 10 * r + b, 0.25 + 0.3 * s + 0.1 * r,
               8.0 * (2 * r - 1) + 6.0 * b, False) for b in range(2)]
             for r in range(WORLD)] for s in range(n)]


# name -> (stage, option overrides, rig, steps)
CASES = {
    "fine_percam": ("fine", {}, False, single_steps(3)),
    "coarse_summed": ("coarse", {"multicam_percam_stats": 0}, False,
                      single_steps(3)),
    "rig_fine": ("fine", {}, True, rig_steps(2)),
    "nan_on_rank1": ("fine", {}, False, single_steps(1, nan_rank=1)),
}


# --------------------------------------------------------------------------
# the ranks: this file run as a script
# --------------------------------------------------------------------------

def numpy_tree(npz):
    """The JAX TrainState written by ``save_numpy_tree``, rebuilt as
    namespaces (attributes) and dicts (keys, indices) of numpy arrays,
    which ``train_state_from_numpy`` reads."""
    root = types.SimpleNamespace()
    for path, arr in npz.items():
        keys = re.findall(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]", path)
        node = root
        for i, (attr, key, idx) in enumerate(keys):
            k = attr or key or int(idx)
            last = i == len(keys) - 1
            nxt = keys[i + 1][0] if not last else None
            if last:
                child = arr
            elif isinstance(node, dict):
                child = node.get(k)
            else:
                child = getattr(node, k, None)
            if child is None:
                child = types.SimpleNamespace() if nxt else {}
            if isinstance(node, dict):
                node[k] = child
            else:
                setattr(node, k, child)
            node = child
    return root


def save_numpy_tree(path, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    np.savez(path, **{jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in leaves})


def load_start(path):
    with np.load(path) as npz:
        return train_state_from_numpy(numpy_tree(dict(npz)), T_HP,
                                      device="cpu")


def rank_main(rank, store, workdir):
    torch.set_num_threads(1)
    assert init_multihost(store, WORLD, rank, backend="gloo",
                          device="cpu") == (rank, WORLD)
    for name, (stage, opt_kw, rig, steps) in CASES.items():
        opt = tcfg.OptimizationParams(**opt_kw)
        state = load_start(os.path.join(workdir, "start.npz"))
        out, agree = {}, []
        for s, per_rank in enumerate(steps):
            cams = [t_cam(spec) for spec in per_rank[rank]]
            if rig:
                state, aux = tdp.parallel_train_step_multicam(
                    state, cams, stage, 3, T_HP, opt, T_PIPE, T_CFG,
                    SPATIAL_LR_SCALE, torch.zeros(3))
            else:
                state, aux = tdp.parallel_train_step(
                    state, cams[0], stage, 3, T_HP, opt, T_PIPE, T_CFG,
                    SPATIAL_LR_SCALE, torch.zeros(3))
            lo, hi = tdp.replica_checksum_range(state)
            agree.append(lo == hi)
            out.update({f"aux{s}.metric.{k}": v.numpy()
                        for k, v in aux["metrics"].items()})
            out.update({f"aux{s}.{k}": aux[k].numpy()
                        for k in tdp.COUNTERS + ("radii", "visible")})
        out.update({f"state.{k}": v.numpy()
                    for k, v in state_tensors(state).items()})
        np.savez(os.path.join(workdir, f"{name}_rank{rank}.npz"),
                 agree=np.array(agree), **out)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the parent: JAX on two virtual devices, the ranks in subprocesses
# --------------------------------------------------------------------------

class RankRuns:
    """The port's ranks over every case, started at once and collected
    when a test first asks (the JAX compiles run meanwhile)."""

    def __init__(self, workdir):
        self.workdir = workdir
        self.ranks = Ranks(os.path.abspath(__file__), workdir)

    def __getitem__(self, case):
        """[rank 0 npz, rank 1 npz] of ``case``."""
        self.ranks.wait()
        out = []
        for r in range(WORLD):
            with np.load(self.workdir / f"{case}_rank{r}.npz") as npz:
                out.append(dict(npz))
        return out


@pytest.fixture(scope="module")
def rank_runs(jax_state, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp")
    save_numpy_tree(str(workdir / "start.npz"), np_tree(jax_state))
    runs = RankRuns(workdir)
    yield runs
    runs.ranks.kill()


@pytest.fixture(scope="module")
def mesh():
    return jdp.make_mesh(WORLD)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's DP steps, compiled once each (``jax_step``)."""
    return {}


def jax_step(jax_steps, mesh, case):
    stage, opt_kw, rig, _ = CASES[case]
    key = (stage, tuple(sorted(opt_kw.items())), rig)
    if key not in jax_steps:
        opt = JOpt(**opt_kw)
        if rig:
            jax_steps[key] = jdp.make_parallel_train_step_multicam(
                mesh, 2, stage, J_HP, opt, J_PIPE, J_CFG, SPATIAL_LR_SCALE)
        else:
            jax_steps[key] = jdp.make_parallel_train_step(
                mesh, stage, J_HP, opt, J_PIPE, J_CFG, SPATIAL_LR_SCALE)
    return jax_steps[key]


def jax_batch(per_rank, rig, mesh):
    """One step's cameras as the JAX DP step takes them, sharded."""
    rows = [stack_cameras([j_cam(s) for s in specs]) if rig
            else j_cam(specs[0]) for specs in per_rank]
    return jdp.shard_camera_batch(stack_cameras(rows), mesh)


def run_jax(jax_state, jax_steps, mesh, case):
    """The JAX DP steps of ``case``: (numpy state, aux of each step)."""
    _, _, rig, steps = CASES[case]
    step = jax_step(jax_steps, mesh, case)
    state = jdp.replicate_state(jtr.clone_state(jax_state), mesh)
    auxes = []
    for per_rank in steps:
        state, aux = step(state, jax_batch(per_rank, rig, mesh),
                          jnp.asarray(3, jnp.int32), jnp.zeros(3))
        auxes.append(np_tree(aux))
    return np_tree(state), auxes


def port_state(jax_state, npz):
    """A port TrainState holding a rank's final tensors."""
    ts = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    for k, v in state_tensors(ts).items():
        v.copy_(torch.from_numpy(npz[f"state.{k}"]))
    return ts


def assert_ranks_bit_equal(r0, r1):
    assert r0["agree"].all() and r1["agree"].all()
    assert sorted(r0) == sorted(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def assert_dp_aux_match(npz, jaux, s):
    metrics = {k[len(f"aux{s}.metric."):]: v for k, v in npz.items()
               if k.startswith(f"aux{s}.metric.")}
    assert sorted(metrics) == sorted(jaux["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jaux["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in tdp.COUNTERS:
        assert int(npz[f"aux{s}.{k}"]) == int(jaux[k]), k


@pytest.mark.parametrize("case", ["fine_percam", "coarse_summed",
                                  "rig_fine"])
def test_dp_steps_match_jax(jax_state, rank_runs, jax_steps, mesh, case):
    js, jauxes = run_jax(jax_state, jax_steps, mesh, case)
    r0, r1 = rank_runs[case]
    assert_ranks_bit_equal(r0, r1)
    for s, jaux in enumerate(jauxes):
        assert_dp_aux_match(r0, jaux, s)
        assert int(r0[f"aux{s}.n_pairs"]) > 0
    ts = port_state(jax_state, r0)
    assert_states_match(ts, js, 1e-5 if len(jauxes) == 1 else 1e-4)
    start = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    assert int(ts.step) == int(start.step) + len(jauxes)
    for k, v in ts.pool.param_dict().items():
        assert not torch.equal(v, start.pool.param_dict()[k]), k


def test_dp_steps_equal_one_jax_scanned_block(jax_state, rank_runs, mesh):
    """Three port DP steps against ``make_parallel_train_steps_scan`` over
    the same three camera batches in one dispatch."""
    _, _, _, steps = CASES["fine_percam"]
    scan = jdp.make_parallel_train_steps_scan(
        mesh, "fine", J_HP, JOpt(), J_PIPE, J_CFG, SPATIAL_LR_SCALE)
    blocks = stack_cameras([stack_cameras([j_cam(specs[0])
                                           for specs in per_rank])
                            for per_rank in steps])
    state = jdp.replicate_state(jtr.clone_state(jax_state), mesh)
    js, jaux = scan(state, jdp.shard_camera_blocks(blocks, mesh),
                    jnp.asarray(3, jnp.int32), jnp.zeros(3))
    jaux = np_tree(jaux)
    r0 = rank_runs["fine_percam"][0]
    for s in range(len(steps)):
        assert_dp_aux_match(r0, jax.tree_util.tree_map(lambda x: x[s], jaux),
                            s)
    assert_states_match(port_state(jax_state, r0), np_tree(js), 1e-4)


def test_nan_on_one_rank_skips_the_step_on_both(jax_state, rank_runs,
                                                jax_steps, mesh):
    js, (jaux,) = run_jax(jax_state, jax_steps, mesh, "nan_on_rank1")
    r0, r1 = rank_runs["nan_on_rank1"]
    assert_ranks_bit_equal(r0, r1)
    assert not np.isfinite(float(jaux["metrics"]["loss"]))
    assert not np.isfinite(float(r0["aux0.metric.loss"]))
    ts = port_state(jax_state, r0)
    assert int(ts.nan_skips) == 1 == int(js.nan_skips)
    start = train_state_from_numpy(np_tree(jax_state), T_HP, device="cpu")
    for k, v in ts.pool.param_dict().items():
        torch.testing.assert_close(v, start.pool.param_dict()[k], rtol=0,
                                   atol=0)
    assert torch.isfinite(ts.stats.xyz_grad_accum).all()
    assert_states_match(ts, js, 1e-5)


@pytest.fixture
def world_of_one(tmp_path):
    assert init_multihost("file://" + str(tmp_path / "store"), 1, 0,
                          backend="gloo", device="cpu") == (0, 1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("rig", [False, True])
def test_world_size_one_equals_train_step(jax_state, world_of_one, rig):
    specs = ([(7, 0.5, 4.0, False), (8, 0.5, -6.0, False)] if rig
             else [(7, 0.5, 4.0, False)])
    opt = tcfg.OptimizationParams()
    args = ("fine", 3, T_HP, opt, T_PIPE, T_CFG, SPATIAL_LR_SCALE,
            torch.zeros(3))
    cams = [t_cam(s) for s in specs]
    out = {}
    for key, fn in (("dp", tdp.parallel_train_step_multicam if rig
                     else tdp.parallel_train_step),
                    ("one", ttr.train_step_multicam if rig
                     else ttr.train_step)):
        state = train_state_from_numpy(np_tree(jax_state), T_HP,
                                       device="cpu")
        state, aux = fn(state, cams if rig else cams[0], *args)
        out[key] = (state, aux)
    (sd, ad), (so, ao) = out["dp"], out["one"]
    assert tdp.replica_checksum(sd) == tdp.replica_checksum(so)
    for k, v in state_tensors(so).items():
        torch.testing.assert_close(state_tensors(sd)[k], v, rtol=0, atol=0,
                                   msg=k)
    for k, v in ao["metrics"].items():
        assert torch.equal(ad["metrics"][k], v), k
    for k in tdp.COUNTERS + ("radii", "visible"):
        assert torch.equal(ad[k], ao[k].to(ad[k].dtype)), k


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
