"""The port's multi-process seam (``parallel/multihost.py``,
``data_parallel.replicate_state``) and its training CLI with
``--batch_size 2`` on two gloo ranks, against ``train.py --batch_size 2``
on two of the conftest's virtual JAX CPU devices (as
``tests/test_cli_parallel.py`` runs it).

The ranks are two subprocesses, each this file run as a script; they find
their group through ``S3G_COORDINATOR`` / ``S3G_NUM_PROCESSES`` /
``S3G_PROCESS_ID`` (a ``file://`` store under ``tmp_path``) and:

  * report ``local_batch_slice`` and ``is_primary`` over two ranks;
  * perturb rank 1's train state, then ``replicate_state``: both ranks
    hold rank 0's state bit for bit, and ``replica_checksum`` agrees
    after and not before;
  * run ``train_cli.main`` on ``tests/waymo_fixture.py``'s clip, rank 1
    with a model path of its own, the JAX CLI's initial field handed to
    both as numpy.  The ranks pop the same batch of 2 cameras a step and
    keep one each, so every logged loss equals ``train.py``'s (rtol 1e-4,
    as ``test_torch_cli.py`` holds one device) up to the first densify
    (coarse step 4), whose counts are equal; only rank 0 writes
    ``logger.json``, ``cfg_args``, ``cameras.json``, the checkpoint and
    the PLY; the final replicas are bit-equal.

In this process: ``init_multihost`` without a coordinator is ``(0, 1)``
and the rest a no-op, and the CLI refuses at startup a single process that
sees as many devices as ``--batch_size`` (naming torchrun) and a group of
another size than ``--batch_size``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.config import ModelHiddenParams as THP
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import create_from_pcd
from s3gaussian_tpu_torch.parallel import data_parallel as tdp
from s3gaussian_tpu_torch.parallel import multihost as mh
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.train.checkpoints import state_tensors

import tiny_config
from test_torch_cli import ARGV, FIRST_DENSIFY, JAX_ARGV, REPO, SEED, \
    read_log, same_field
from torch_ranks import GROUP_ENV, WORLD, Ranks
from torch_threads import one_torch_thread  # noqa: F401
from waymo_fixture import make_fixture

# the CLI runs: the coarse stage past its first densify (step 4), no fine
# steps; every step logged
CLI_ARGV = ARGV + ["--batch_size", str(WORLD), "--iterations", "0",
                   "--skip_final_eval"]
WRITTEN = ("logger.json", "cfg_args", "cameras.json", "chkpnt_fine_0",
           "point_cloud")


def small_state():
    """A port train state of 64 rows, the same on every rank."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    pool = create_from_pcd(pts, rng.random((40, 3)).astype(np.float32), 64,
                           device="cpu")
    field = DeformationField(THP(**tiny_config.ModelHiddenParams),
                             torch.Generator().manual_seed(0), "cpu")
    return ttr.init_state(pool, field, torch.tensor([[3.0] * 3, [-3.0] * 3]))


# --------------------------------------------------------------------------
# the ranks: this file run as a script
# --------------------------------------------------------------------------

def rank_main(rank, store, workdir):
    torch.set_num_threads(1)
    os.environ.update(S3G_COORDINATOR=store, S3G_NUM_PROCESSES=str(WORLD),
                      S3G_PROCESS_ID=str(rank))
    assert mh.init_multihost(device="cpu") == (rank, WORLD)
    report = {"slices": {b: mh.local_batch_slice(b) for b in (2, 4)},
              "primary": mh.is_primary()}
    try:
        mh.local_batch_slice(3)
    except ValueError as e:
        report["slice_3"] = str(e)

    # replicate_state over a perturbed rank 1
    state = small_state()
    if rank == 1:
        state.pool.xyz.add_(0.5)
        state.pool.alive[:3] = ~state.pool.alive[:3]
        state.adam.count.fill_(7)
        state.step.fill_(3)
        next(state.deform.parameters()).data.mul_(2.0)
    report["before"] = tdp.replica_checksum_range(state)
    state = tdp.replicate_state(state)
    report["after"] = tdp.replica_checksum_range(state)
    np.savez(os.path.join(workdir, f"replicated_rank{rank}.npz"),
             **{k: v.numpy() for k, v in state_tensors(state).items()})

    # the CLI: the group is up, so its init_multihost returns it
    with np.load(os.path.join(workdir, "field.npz")) as npz:
        weights = {k: torch.from_numpy(v) for k, v in npz.items()}

    def field_from_jax(hyper, seed, device):
        field = DeformationField(hyper, torch.Generator().manual_seed(seed),
                                 device)
        field.load_state_dict(weights)
        return field

    train_cli.make_deformation = field_from_jax
    out = os.path.join(workdir, f"port_rank{rank}")
    state = train_cli.main(["-s", os.path.join(workdir, "clip"),
                            "--model_path", out, "--seed", str(SEED)]
                           + CLI_ARGV, device="cpu")
    report["final"] = tdp.replica_checksum_range(state)
    np.savez(os.path.join(workdir, f"cli_rank{rank}.npz"),
             **{k: v.numpy() for k, v in state_tensors(state).items()})
    with open(os.path.join(workdir, f"report_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, started first, and the JAX CLI meanwhile: (workdir, JAX
    model path, [report of each rank])."""
    workdir = tmp_path_factory.mktemp("multihost")
    make_fixture(str(workdir / "clip"), n_frames=3)
    field = same_field(THP(**tiny_config.ModelHiddenParams), SEED, "cpu")
    np.savez(workdir / "field.npz",
             **{k: v.numpy() for k, v in field.state_dict().items()})
    ranks = Ranks(os.path.abspath(__file__), workdir,
                  env={"S3G_LOG_EVERY": "1"})
    try:
        sys.path.insert(0, REPO)
        import train as jax_cli

        jout = str(workdir / "jax")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("S3G_LOG_EVERY", "1")
            jax_cli.main(["-s", str(workdir / "clip"), "--model_path", jout,
                          "--seed", str(SEED)] + JAX_ARGV
                         + CLI_ARGV[len(ARGV):])
        ranks.wait()
    finally:
        ranks.kill()
    reports = []
    for r in range(WORLD):
        with open(workdir / f"report_rank{r}.json") as f:
            reports.append(json.load(f))
    return workdir, jout, reports


def load(path):
    with np.load(path) as npz:
        return dict(npz)


def test_batch_slices_and_primary_over_two_ranks(runs):
    _, _, reports = runs
    for r, rep in enumerate(reports):
        assert rep["slices"] == {"2": [r, r + 1], "4": [2 * r, 2 * r + 2]}
        assert rep["primary"] == (r == 0)
        assert "does not divide" in rep["slice_3"]


def test_replicate_state_overwrites_rank1_with_rank0(runs):
    workdir, _, reports = runs
    lo, hi = reports[0]["before"]
    assert lo != hi
    assert all(rep["after"][0] == rep["after"][1] == reports[0]["after"][0]
               for rep in reports)
    r0, r1 = (load(workdir / f"replicated_rank{r}.npz") for r in range(2))
    want = {k: v.numpy() for k, v in state_tensors(small_state()).items()}
    assert sorted(r0) == sorted(r1) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(r1[k], want[k], err_msg=k)
        np.testing.assert_array_equal(r0[k], want[k], err_msg=k)


def test_cli_losses_match_train_py_up_to_the_first_densify(runs):
    workdir, jout, _ = runs
    jlog, tlog = read_log(jout), read_log(workdir / "port_rank0")

    def losses(log):
        return {l["step"]: l["Loss"] for l in log
                if l.get("stage") == "coarse" and "Loss" in l
                and l["step"] <= FIRST_DENSIFY}

    want, got = losses(jlog), losses(tlog)
    assert sorted(got) == sorted(want) == list(range(1, FIRST_DENSIFY + 1))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-4)

    def first_densify(log):
        return next(l["densify"] for l in log if "densify" in l)

    assert first_densify(tlog) == first_densify(jlog)
    for line in tlog:
        if "Loss" in line:
            assert np.isfinite(line["Loss"]) and line["ovf_pairs"] == 0


def test_only_rank0_writes_and_the_replicas_end_equal(runs):
    workdir, _, reports = runs
    r0_out, r1_out = workdir / "port_rank0", workdir / "port_rank1"
    for name in WRITTEN:
        assert (r0_out / name).exists(), name
    assert not any((r1_out / name).exists() for name in WRITTEN), \
        sorted(os.listdir(r1_out))
    log = read_log(r0_out)
    steps = [l["step"] for l in log if "Loss" in l]
    assert steps == sorted(set(steps))          # one line a logged step
    lo, hi = reports[0]["final"]
    assert lo == hi == reports[1]["final"][0]
    r0, r1 = (load(workdir / f"cli_rank{r}.npz") for r in range(2))
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    flat = torch.load(r0_out / "chkpnt_fine_0" / "state.pt",
                      weights_only=True)
    np.testing.assert_array_equal(flat["pool.xyz"].numpy(), r0["pool.xyz"])


def test_no_coordinator_is_a_single_process(monkeypatch):
    for k in GROUP_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mh.init_multihost(device="cpu") == (0, 1)
    assert not dist.is_initialized()
    assert mh.rank_world() == (0, 1)
    assert mh.local_batch_slice(4) == (0, 4)
    assert mh.is_primary()
    mh.sync_hosts("no-op")
    state = small_state()
    before = tdp.replica_checksum(state)
    assert tdp.replicate_state(state) is state
    assert tdp.replica_checksum(state) == before


@pytest.mark.parametrize("world,visible,batch,match", [
    (1, 2, 2, "torchrun --nproc_per_node 2 -m "
              "s3gaussian_tpu_torch.train_cli"),
    (1, 8, 4, "torchrun --nproc_per_node 4"),
    (2, 1, 4, "2 ranks for --batch_size 4"),
    (2, 1, 1, "2 ranks for --batch_size 1"),
])
def test_startup_refusals(tmp_path, monkeypatch, world, visible, batch,
                          match):
    """A single process that sees at least --batch_size devices, or a
    group of another size, is refused before the reader (the source does
    not exist) and writes nothing."""
    monkeypatch.setattr(train_cli, "init_multihost",
                        lambda device: (0, world))
    monkeypatch.setattr(train_cli, "visible_devices", lambda device: visible)
    argv = ["-s", str(tmp_path / "no_clip"), "--model_path",
            str(tmp_path / "out"), "--batch_size", str(batch)]
    with pytest.raises(SystemExit, match=match):
        train_cli.main(argv, device="cpu")
    assert not os.path.exists(tmp_path / "out")


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
