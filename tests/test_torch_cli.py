"""The port's training CLI against the JAX package's (``train.py``) on the
fabricated Waymo clip, both on the CPU with the same argv (the JAX CLI's
also caps its jnp compositor's pairs per tile) and the same initial field
(the port's ``make_deformation`` is given the JAX ``init_deformation``
weights).

Up to the first densify (coarse step 4) the two runs see the same cameras
(python ``random`` seeded alike) from the same state, so every logged
``Loss`` agrees to rtol 1e-4 and that densify's counts are equal; after
it the split noise differs (``jax.random`` against a ``torch.Generator``).
The logger keys, ``cameras.json`` and the ``cfg_args`` fields match; the
port resumes from its own checkpoint, transplants a prior field across
pool capacities, and refuses at startup every run it cannot finish.

A second port run, with no eval flag, ``--stride 2`` and the mid-training
sweep moved to fine step 3, ends in the evaluation sweep (metrics JSONs
and frames of the test, train and full splits); ``--eval_only`` then
restores its checkpoint and reproduces the final sweep's metrics, and on
a model path without a checkpoint refuses.
"""

import ast
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.config import apply_config_file as j_apply_config_file
from s3gaussian_tpu.config import ModelParams as JMP
from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import PipelineParams as JPipe
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.config import ModelHiddenParams as THP
from s3gaussian_tpu_torch.weights import deformation_from_numpy

from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny_config.py")
LPIPS_FIXTURE = os.path.join(HERE, "fixtures", "lpips_alex_fixture.npz")
SEED = 6666
FIRST_DENSIFY = 4
# test_cli_e2e.py's argv without --max_pairs_per_tile, a field the port
# does not have: the JAX CLI alone gets it (JAX_ARGV).  It caps the jnp
# compositor's chunks per tile, which the fixture's tiles stay under, so
# both CLIs composite every pair; at its default (16384) the JAX run
# scans 32 times the chunks and takes twice as long
ARGV = ["--num_pts", "500",
        "--coarse_iterations", "6", "--iterations", "12",
        "--densification_interval", "4", "--densify_from_iter", "2",
        "--opacity_reset_interval", "1000",
        "--checkpoint_iterations", "12",
        "--bench_iters", "6",
        "--max_visible", "2048", "--rect_w", "4", "--rect_h", "4",
        "--chunk", "32",
        "--load_h", "64", "--load_w", "96",
        "--configs", TINY]
JAX_ARGV = ARGV + ["--max_pairs_per_tile", "512"]


def read_log(out):
    with open(os.path.join(out, "logger.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def jax_hp():
    hp = JHP()
    j_apply_config_file(TINY, JMP(), JPipe(), JOpt(), hp)
    return hp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs once, with S3G_LOG_EVERY=1: (clip, jax out, port out)."""
    root = tmp_path_factory.mktemp("cli")
    src = make_fixture(str(root / "clip"), n_frames=3)
    jout, tout = str(root / "jax"), str(root / "port")
    sys.path.insert(0, REPO)
    import train as jax_cli

    field = jax.tree_util.tree_map(
        np.asarray, init_deformation(jax.random.PRNGKey(SEED), jax_hp()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        jax_cli.main(["-s", src, "--model_path", jout, "--seed", str(SEED)]
                     + JAX_ARGV)
        mp.setattr(train_cli, "make_deformation",
                   lambda hyper, seed, device: deformation_from_numpy(
                       field, hyper, device))
        state = train_cli.main(["-s", src, "--model_path", tout, "--seed",
                                str(SEED)] + ARGV, device="cpu")
    return src, jout, tout, state


def test_losses_match_up_to_the_first_densify(runs):
    _, jout, tout, _ = runs
    jlog, tlog = read_log(jout), read_log(tout)

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
    assert first_densify(tlog)["n_cloned"] + first_densify(tlog)["n_split"] > 0


def test_logger_keys_and_cadence_match(runs):
    _, jout, tout, _ = runs
    jlog, tlog = read_log(jout), read_log(tout)

    def shape(log):
        return [(l.get("stage"), l.get("step"), sorted(l),
                 sorted(l.get("densify", {}))) for l in log]

    assert shape(tlog) == shape(jlog)
    for line in tlog:
        if "Loss" in line:
            assert np.isfinite(line["Loss"])
            assert line["ovf_pairs"] == 0 and line["nan_skips"] == 0


def test_cameras_json_is_identical(runs):
    _, jout, tout, _ = runs
    with open(os.path.join(jout, "cameras.json")) as f:
        want = f.read()
    with open(os.path.join(tout, "cameras.json")) as f:
        assert f.read() == want
    assert len(json.loads(want)) == 9


def test_cfg_args_fields_match(runs):
    _, jout, tout, _ = runs
    with open(os.path.join(jout, "cfg_args")) as f:
        want = ast.literal_eval(f.read())
    with open(os.path.join(tout, "cfg_args")) as f:
        got = ast.literal_eval(f.read())
    # the TPU-only fields and the flag of the scanned dispatch
    assert set(want) - set(got) == {
        "steps_per_dispatch", "remat_deform", "max_pairs_per_tile",
        "use_pallas", "sort_bf16", "sort_hier", "multicam_serialize",
        "multicam_scan"}
    assert set(got) <= set(want)
    for k, v in got.items():
        if k != "model_path":
            assert v == want[k], k
    assert got["net_width"] == 16            # the config file was merged


def test_final_checkpoint_and_ply(runs):
    _, _, tout, state = runs
    assert sorted(d for d in os.listdir(tout) if d.startswith("chkpnt_")) \
        == ["chkpnt_fine_12"]
    flat = torch.load(os.path.join(tout, "chkpnt_fine_12", "state.pt"),
                      weights_only=True)
    torch.testing.assert_close(flat["pool.xyz"], state.pool.xyz)
    from s3gaussian_tpu_torch.utils.ply import read_ply
    ply = read_ply(os.path.join(tout, "point_cloud", "iteration_12",
                                "point_cloud.ply"))
    assert len(ply["x"]) == int(flat["pool.alive"].sum()) \
        == read_log(tout)[-1]["point"]


def test_start_checkpoint_resumes_the_fine_stage(runs, tmp_path):
    src, _, tout, state = runs
    out = str(tmp_path / "resumed")
    resumed = train_cli.main(
        ["-s", src, "--model_path", out, "--iterations", "14",
         "--checkpoint_iterations", "99", "--skip_final_eval",
         "--start_checkpoint", os.path.join(tout, "chkpnt_fine_12")]
        + ARGV[ARGV.index("--max_visible"):], device="cpu")
    log = read_log(out)
    # no coarse stage; the fine stage goes on at 13 with the loaded
    # optimizer state and pool
    assert [(l["stage"], l["step"]) for l in log if "Loss" in l] == \
        [("fine", 13)]
    assert int(resumed.step) == int(state.step) + 2
    assert int(resumed.adam.count) == int(state.adam.count) + 2
    assert log[0]["point"] == int(state.pool.n_alive)


def test_prior_checkpoint_transplants_across_capacities(runs, tmp_path):
    src, _, tout, state = runs
    out = str(tmp_path / "warm")
    warm = train_cli.main(
        ["-s", src, "--model_path", out, "--pool_capacity", "4096",
         "--coarse_iterations", "2", "--iterations", "0",
         "--skip_final_eval", "--checkpoint_iterations", "99",
         "--prior_checkpoint", os.path.join(tout, "chkpnt_fine_12")]
        + ARGV[ARGV.index("--max_visible"):], device="cpu")
    assert warm.pool.capacity == 4096 != state.pool.capacity
    for k, v in warm.deform.state_dict().items():
        torch.testing.assert_close(v, state.deform.state_dict()[k], rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("flags,item", [
    (["--multicam", "3"], "item 4"),
    (["--batch_size", "2"], "item 5"),
    (["--skip_final_eval", "--bench_iters", "5", "--cull_before_deform"],
     "item 1"),
    (["--skip_final_eval", "--bench_iters", "5", "--big_budget", "64"],
     "item 1"),
])
def test_unported_runs_are_refused_at_startup(tmp_path, flags, item):
    # the source does not exist: a refusal must come before the reader
    argv = ["-s", str(tmp_path / "no_clip"), "--model_path",
            str(tmp_path / "out")] + flags
    with pytest.raises(SystemExit, match=f"ROADMAP.md §1 {item}"):
        train_cli.main(argv, device="cpu")
    assert not os.path.exists(tmp_path / "out")


# the eval run: no eval flag, a test split (--stride 2: frame 2 of 3),
# a small pool (the default capacity, 2^16 rows, makes every sweep
# render cost what a train step costs) and the mid-training sweep moved
# from iteration 30000 to fine step 3
MID = 3
EVAL_ARGV = ["--num_pts", "500", "--pool_capacity", "4096", "--stride", "2",
             "--coarse_iterations", "2", "--iterations", "4",
             "--densification_interval", "100",
             "--checkpoint_iterations", "99"] + ARGV[ARGV.index(
                 "--max_visible"):]
METRICS = {"psnr", "ssim", "masked_psnr", "masked_ssim", "lpips"}
FRAMES = {"rgbs", "gt_rgbs", "depths", "dynamic_rgbs", "static_rgbs",
          "forward_flows", "backward_flows"}


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """The port's CLI with its eval sweeps, then ``--eval_only`` on its
    model path: (clip, out, final state, [(step, stage, results)] of each
    sweep, how many sweeps the training run made)."""
    root = tmp_path_factory.mktemp("cli_eval")
    src = make_fixture(str(root / "clip"), n_frames=3)
    out = str(root / "out")
    sweeps = []
    orig = train_cli.do_evaluation

    def recording(*a, **k):
        res = orig(*a, **k)
        sweeps.append((k["step"], a[9], res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LPIPS_WEIGHTS", LPIPS_FIXTURE)
        mp.setattr(train_cli, "MID_EVAL_ITER", MID)
        mp.setattr(train_cli, "do_evaluation", recording)
        state = train_cli.main(["-s", src, "--model_path", out] + EVAL_ARGV,
                               device="cpu")
        n_train = len(sweeps)
        train_cli.main(["-s", src, "--model_path", out, "--eval_only"]
                       + EVAL_ARGV, device="cpu")
    return src, out, state, sweeps, n_train


def read_metrics(out, step):
    d = os.path.join(out, "eval", "metrics")
    found = {}
    for name in sorted(os.listdir(d)):
        parts = name.split("_")
        if parts[0] == str(step):
            with open(os.path.join(d, name)) as f:
                found[parts[2]] = json.load(f)
    return found


def test_a_default_run_ends_with_the_eval_sweep(eval_run):
    _, out, state, sweeps, n_train = eval_run
    step = int(state.step)
    assert sweeps[n_train - 1][:2] == (step, "fine") and step > MID
    found = read_metrics(out, step)
    assert found.keys() == {"test", "train", "full"}
    for split, m in found.items():
        assert m.keys() == METRICS, split
        assert np.isfinite(m["psnr"]) and np.isfinite(m["ssim"])
        assert isinstance(m["lpips"], float)
        assert isinstance(m["masked_psnr"], float)
    files = os.listdir(os.path.join(out, "eval", f"full_set_{step}"))
    # 3 timestamps of the 3-camera rig, one PNG each (no mp4 backend)
    assert sorted(files) == sorted(f"{k}_{i:03d}.png" for k in FRAMES
                                   for i in range(3))


def test_the_mid_training_sweep_runs_at_mid_eval_iter(eval_run):
    _, out, _, sweeps, n_train = eval_run
    assert n_train == 2 and sweeps[0][:2] == (MID, "fine")
    assert read_metrics(out, MID).keys() == {"test", "train", "full"}
    assert os.path.isdir(os.path.join(out, "eval", f"train_set_{MID}"))


def test_stride_2_gives_a_test_split(eval_run):
    _, out, state, sweeps, n_train = eval_run
    assert sweeps[n_train - 1][2].keys() == {"test", "train", "full"}
    test_dir = os.path.join(out, "eval", f"test_set_{int(state.step)}")
    # one rig (frame 2): one timestamp, three cameras side by side, and
    # no flow renders (a split of one rig has no other frame)
    assert sorted(os.listdir(test_dir)) == sorted(
        f"{k}_000.png" for k in FRAMES - {"forward_flows", "backward_flows"})
    with open(os.path.join(test_dir, "rgbs_000.png"), "rb") as f:
        from s3gaussian_tpu_torch.data.images import decode_png
        assert decode_png(f.read()).shape == (64, 3 * 96, 3)


def test_eval_only_reproduces_the_final_sweep(eval_run):
    _, _, state, sweeps, n_train = eval_run
    assert len(sweeps) == n_train + 1
    (step, stage, want), (step2, stage2, got) = sweeps[n_train - 1:]
    assert (step2, stage2) == (step, stage) == (int(state.step), "fine")
    assert got.keys() == want.keys()
    for split in want:
        for k, v in want[split].items():
            np.testing.assert_allclose(got[split][k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{split} {k}")


def test_eval_only_refuses_without_a_checkpoint(eval_run, tmp_path):
    src = eval_run[0]
    with pytest.raises(SystemExit, match="no checkpoint"):
        train_cli.main(["-s", src, "--model_path", str(tmp_path / "fresh"),
                        "--eval_only"] + EVAL_ARGV, device="cpu")
