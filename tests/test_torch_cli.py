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
pool capacities, refuses at startup a data-parallel run in one process
that sees the devices for it (naming torchrun), and falls back to batch size 1 where the devices are fewer than
``--batch_size``, as ``train.py`` does.

Two more pairs of runs: the reference's density control past a short
opacity-reset interval (the 20-px screen prune on), with the port's
``densify_step`` fed the JAX CLI's split draws, gives the same densify
counts and alive count at every step of both stages; and
``arguments/waymo_perf.py``'s flags (a 3-camera rig a step, the
pre-deformation cull, the auto-sized budget) give the same auto-sized
``max_visible`` and losses up to the first densify (rtol 1e-4).  The
port alone runs the preset file itself with the default model through
both stages and the final sweep.

A second port run, with no eval flag, ``--stride 2`` and the mid-training
sweep moved to fine step 3, ends in the evaluation sweep (metrics JSONs
and frames of the test, train and full splits); ``--eval_only`` then
restores its checkpoint and reproduces the final sweep's metrics, and on
a model path without a checkpoint refuses.
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.config import FieldParams
from s3gaussian_tpu_torch.train import trainer as ttr

import torch_cli_pairs
from torch_cli_pairs import read_log
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


# the port's make_deformation giving the JAX CLI's initial field
same_field = torch_cli_pairs.same_field(TINY)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs once, with S3G_LOG_EVERY=1: (clip, jax out, port out)."""
    root = tmp_path_factory.mktemp("cli")
    src = make_fixture(str(root / "clip"), n_frames=3)
    jout, tout = str(root / "jax"), str(root / "port")
    sys.path.insert(0, REPO)
    import train as jax_cli

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        jax_cli.main(["-s", src, "--model_path", jout, "--seed", str(SEED)]
                     + JAX_ARGV)
        mp.setattr(train_cli, "make_deformation", same_field)
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
    # the TPU-only fields; the port's own group (FieldParams) at its
    # default, the hexplane field the JAX run trains
    assert set(want) - set(got) == {
        "remat_deform", "max_pairs_per_tile", "use_pallas", "sort_bf16",
        "sort_hier", "multicam_serialize", "multicam_scan"}
    port_only = dataclasses.asdict(FieldParams())
    assert {k: got[k] for k in set(got) - set(want)} == port_only
    for k, v in got.items():
        if k != "model_path" and k not in port_only:
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


@pytest.mark.parametrize("flags,match", [
    (["--batch_size", "2"], "launch torchrun --nproc_per_node 2 -m "
                            "s3gaussian_tpu_torch.train_cli"),
])
def test_unported_runs_are_refused_at_startup(tmp_path, monkeypatch, flags,
                                              match):
    # a single process that sees as many devices as --batch_size (two
    # here) is refused: the port runs one process per device, so it
    # would train at batch size 1 where train.py uses the devices; the
    # source does not exist: a refusal must come before the reader
    monkeypatch.setattr(train_cli, "visible_devices", lambda device: 2)
    argv = ["-s", str(tmp_path / "no_clip"), "--model_path",
            str(tmp_path / "out")] + flags
    with pytest.raises(SystemExit, match=match):
        train_cli.main(argv, device="cpu")
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("flags", [
    ["--multicam", "3"],
    ["--skip_final_eval", "--bench_iters", "5", "--cull_before_deform"],
    ["--skip_final_eval", "--bench_iters", "5", "--big_budget", "64"],
])
def test_rig_cull_and_two_class_runs_pass_the_startup_check(tmp_path,
                                                            flags):
    # the run gets past the check to the reader, which finds no clip
    argv = ["-s", str(tmp_path / "no_clip"), "--model_path",
            str(tmp_path / "out")] + flags
    with pytest.raises(ValueError, match="Could not recognize scene type"):
        train_cli.main(argv, device="cpu")
    assert os.path.isdir(tmp_path / "out")


def test_batch_size_beyond_the_devices_falls_back_to_one(runs, tmp_path,
                                                         capsys):
    """As train.py:216-219: with fewer devices than --batch_size the run
    prints the note and trains with batch size 1, step for step the run
    without the flag."""
    src, _, tout, _ = runs
    out = str(tmp_path / "bs2")
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        mp.setattr(train_cli, "make_deformation", same_field)
        train_cli.main(["-s", src, "--model_path", out, "--seed", str(SEED),
                        "--batch_size", "2"] + ARGV
                       + ["--bench_iters", "2", "--iterations", "0"],
                       device="cpu")
    assert ("batch_size=2 needs >= that many devices (have 1); falling "
            "back to batch_size=1") in capsys.readouterr().out

    def coarse(log):
        return [(l["step"], l["Loss"], l["point"]) for l in log
                if l.get("stage") == "coarse" and "Loss" in l][:2]

    assert coarse(read_log(out)) == coarse(read_log(tout))


class JaxDraws:
    """The port's ``densify_step`` fed the split noise the JAX CLI draws:
    ``jax.random.PRNGKey(seed)`` anew each stage (the port's CLI makes a
    new generator each stage), split once per densify, the two normals
    of ``densify_and_prune`` from that key's split."""

    def __init__(self, seed):
        self.seed, self.gen, self.key = seed, None, None

    def __call__(self, state, generator, *args, **kw):
        if generator is not self.gen:
            self.gen, self.key = generator, jax.random.PRNGKey(self.seed)
        self.key, sub = jax.random.split(self.key)
        shape = tuple(state.pool.xyz.shape)
        noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                      for k in jax.random.split(sub))
        return ttr.densify_step(state, generator, *args, noise=noise, **kw)


def run_both(root, argv, jax_extra=(), draws=False):
    """The JAX CLI and the port's on a fresh fixture clip with
    S3G_LOG_EVERY=1 and the same initial field; the port's densify_step
    gets the JAX CLI's split noise with ``draws``.  Returns (jax out,
    port out, the printed output of each)."""
    src = make_fixture(str(root / "clip"), n_frames=3)
    jout, tout = str(root / "jax"), str(root / "port")
    sys.path.insert(0, REPO)
    import train as jax_cli

    printed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            jax_cli.main(["-s", src, "--model_path", jout, "--seed",
                          str(SEED)] + argv + list(jax_extra))
        printed.append(buf.getvalue())
        mp.setattr(train_cli, "make_deformation", same_field)
        if draws:
            mp.setattr(train_cli, "densify_step", JaxDraws(SEED))
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            train_cli.main(["-s", src, "--model_path", tout, "--seed",
                            str(SEED)] + argv, device="cpu")
        printed.append(buf.getvalue())
    return jout, tout, printed


# the fine-stage collapse check: the reference's density control with a
# short opacity-reset interval, so the densifies past it (steps 4, 6, 8
# of each stage) carry the 20-px screen prune, as the fine stage of a
# long run does after its first reset
COLLAPSE_ARGV = ["--num_pts", "500",
                 "--coarse_iterations", "6", "--iterations", "8",
                 "--densification_interval", "2", "--densify_from_iter", "1",
                 "--opacity_reset_interval", "3",
                 "--checkpoint_iterations", "99", "--skip_final_eval",
                 "--max_visible", "2048", "--rect_w", "4", "--rect_h", "4",
                 "--chunk", "32", "--load_h", "64", "--load_w", "96",
                 "--configs", TINY]


@pytest.fixture(scope="module")
def collapse_runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("collapse"), COLLAPSE_ARGV,
                    ["--max_pairs_per_tile", "512"], draws=True)


def test_density_control_past_the_reset_follows_the_reference(
        collapse_runs):
    """With the JAX CLI's split draws, the port's densify and prune
    counts and its alive count equal the reference's at every step of
    both stages, the screen prunes past the reset included."""
    jout, tout, _ = collapse_runs
    jlog, tlog = read_log(jout), read_log(tout)

    def densifies(log):
        return [(l["stage"], l["step"], l["densify"]) for l in log
                if "densify" in l]

    def alive(log):
        return [(l["stage"], l["step"], l["point"]) for l in log
                if "Loss" in l]

    assert densifies(tlog) == densifies(jlog)
    assert [(st, s) for st, s, _ in densifies(tlog)] == [
        (st, s) for st in ("coarse", "fine") for s in (2, 4, 6)] + [
        ("fine", 8)]
    assert alive(tlog) == alive(jlog)
    assert sum(d["n_prune_screen"] for _, s, d in densifies(tlog)) > 0
    resets = [(l["stage"], l["step"]) for l in tlog if "opacity_reset" in l]
    assert resets == [("coarse", 3), ("coarse", 6), ("fine", 3), ("fine", 6)]


# arguments/waymo_perf.py's flags (its multicam_scan is TPU-only: the
# JAX CLI alone gets it), with the fixture's cuts of ARGV
WAYMO_PERF_ARGV = ["--multicam", "3", "--multicam_lr_scale", "1.0",
                   "--cull_before_deform", "--max_visible", "0"] + [
    a for a in ARGV if a not in ("--max_visible", "2048")]


@pytest.fixture(scope="module")
def waymo_perf_runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("waymo_perf"), WAYMO_PERF_ARGV,
                    ["--max_pairs_per_tile", "512", "--multicam_scan"])


def test_waymo_perf_losses_match_up_to_the_first_densify(waymo_perf_runs):
    jout, tout, (jprint, tprint) = waymo_perf_runs
    jlog, tlog = read_log(jout), read_log(tout)

    def losses(log):
        return {l["step"]: l["Loss"] for l in log
                if l.get("stage") == "coarse" and "Loss" in l
                and l["step"] <= FIRST_DENSIFY}

    want, got = losses(jlog), losses(tlog)
    assert sorted(got) == sorted(want) == list(range(1, FIRST_DENSIFY + 1))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-4)
    first = [next(l["densify"] for l in log if "densify" in l)
             for log in (tlog, jlog)]
    assert first[0] == first[1]

    def budget(text):
        return [line for line in text.splitlines()
                if line.startswith("auto-sized max_visible")]

    assert budget(tprint) == budget(jprint) and len(budget(tprint)) == 1
    # both stages ran to their ends, the fine one culled, no overflow
    assert [l["step"] for l in tlog if l.get("stage") == "fine"
            and "Loss" in l][-1] == 6
    for line in tlog:
        if "Loss" in line:
            assert np.isfinite(line["Loss"]) and line["nan_skips"] == 0
            assert line["ovf_pairs"] == 0 and line["ovf_vis"] == 0


def test_waymo_perf_preset_trains_and_evaluates(tmp_path, capsys):
    """The preset itself (``--configs arguments/waymo_perf.py``, the
    default model) through both stages and the final sweep on the
    fixture: 3-camera rig steps, the cull, the auto-sized budget."""
    src = make_fixture(str(tmp_path / "clip"), n_frames=3)
    out = str(tmp_path / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        state = train_cli.main(
            ["-s", src, "--model_path", out, "--configs",
             os.path.join(REPO, "arguments", "waymo_perf.py"),
             "--num_pts", "500", "--pool_capacity", "4096",
             "--coarse_iterations", "3", "--iterations", "3",
             "--densification_interval", "2", "--densify_from_iter", "1",
             "--checkpoint_iterations", "99", "--load_h", "64",
             "--load_w", "96"], device="cpu")
    printed = capsys.readouterr().out
    assert "auto-sized max_visible = " in printed
    # the operator's span lines: set-up once, then each logged step's
    # spans (the fine steps' first span is the cull) and field rows
    assert "host spans (s): pool.init " in printed
    assert printed.count("spans (ms): ") == 6
    assert printed.count("spans (ms): cull ") == 3
    assert printed.count("; visible rows / field rows ") == 3
    log = read_log(out)
    assert [(l["stage"], l["step"]) for l in log if "Loss" in l] == [
        (st, i) for st in ("coarse", "fine") for i in (1, 2, 3)]
    for line in log:
        if "Loss" in line:
            assert np.isfinite(line["Loss"]) and line["nan_skips"] == 0
            assert line["ovf_pairs"] == 0 and line["ovf_vis"] == 0
    assert sum("densify" in l for l in log) == 2
    assert int(state.step) == 3 and int(state.adam.count) == 3
    assert read_metrics(out, 3).keys() == {"train", "full"}


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
