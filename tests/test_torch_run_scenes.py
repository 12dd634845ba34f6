"""The port's multi-scene driver (``s3gaussian_tpu_torch/tools/
run_scenes.py``) against ``scripts/run_scenes.py``: with ``--dry_run``
both print the same command for every scene but the entry point
(``python -m s3gaussian_tpu_torch.train_cli``, or ``torchrun
--nproc_per_node B -m ...`` for a forwarded ``--batch_size B``), skip the
same scenes and exit alike, over a split file, a shard, the latest fine
checkpoint under ``--prior_root`` (chosen by iteration, not by name) and
a scene without one.  Then two fabricated scenes train in this process
on the CPU, their phase-2 warm start chains off them through
``--prior_root``, and ``scripts/cal.py`` averages the two scenes' test
metrics.
"""

import ast
import contextlib
import importlib.util
import io
import json
import math
import os
import sys

import pytest

from s3gaussian_tpu_torch.tools import run_scenes

from torch_cli_pairs import merged_preset
from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny_config.py")
SPLIT = os.path.join(REPO, "data", "waymo_splits", "dynamic32.txt")


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dry_runs(argv, capsys):
    """Both scripts' --dry_run on ``argv``: for each, (exit code, the
    printed lines before the summary, the summary)."""
    out = []
    for main in (script("run_scenes").main, run_scenes.main):
        rc = main(["--dry_run"] + argv)
        text = capsys.readouterr().out
        head, _, tail = text.partition("\n[\n")
        lines = head.splitlines() if tail else []
        summary = json.loads("[\n" + tail) if tail else json.loads(text)
        out.append((rc, lines, summary))
    return out


def split_entry(line):
    """A command line -> (scene tag, entry point, the CLI's arguments)."""
    tag, cmd = line.split(" ", 1)
    parts = cmd.split(" ")
    if parts[0] == sys.executable and parts[1].endswith("train.py"):
        return tag, parts[:2], parts[2:]
    at = parts.index(run_scenes.ENTRY) + 1
    return tag, parts[:at], parts[at:]


@pytest.fixture(scope="module")
def prior_root(tmp_path_factory):
    """Scene 016 with fine checkpoints 8 and 12 and a coarse one; 021
    with only a coarse checkpoint; 022 with none."""
    root = tmp_path_factory.mktemp("prior")
    for scene, names in (("016", ("chkpnt_fine_8", "chkpnt_fine_12",
                                  "chkpnt_coarse_30")),
                         ("021", ("chkpnt_coarse_3",)), ("022", ())):
        os.makedirs(root / scene)
        for name in names:
            os.makedirs(root / scene / name)
    return str(root)


CASES = {
    "split_file": ["--split_file", SPLIT],
    "shard_1_of_2": ["--scenes", "016", "021", "022", "025", "--shard",
                     "1/2", "--configs", "arguments/nvs.py"],
    "prior_root": ["--scenes", "016", "021", "022", "--configs",
                   "arguments/stage2.py", "--prior_root", None],
    "batch_size_2": ["--scenes", "016", "021", "--expname", "dp", "--",
                     "--batch_size", "2", "--multicam", "3"],
    "data_root": [],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dry_run_matches_the_script_but_for_the_entry_point(
        case, prior_root, tmp_path, capsys):
    data_root = tmp_path / "data"
    for scene in ("016", "021"):
        os.makedirs(data_root / scene)
    argv = ["--data_root", str(data_root), "--output",
            str(tmp_path / "out")] + [prior_root if a is None else a
                                      for a in CASES[case]]
    (jrc, jlines, jsum), (trc, tlines, tsum) = dry_runs(argv, capsys)
    assert (trc, tsum) == (jrc, jsum)
    assert len(tlines) == len(jlines) > 0
    for t, j in zip(tlines, jlines):
        if " no prior checkpoint under " in j:
            assert t == j
            continue
        (ttag, tentry, targs), (jtag, _, jargs) = map(split_entry, (t, j))
        assert (ttag, targs) == (jtag, jargs)
        if case == "batch_size_2":
            assert tentry == ["torchrun", "--nproc_per_node", "2", "-m",
                              run_scenes.ENTRY]
        else:
            assert tentry == [sys.executable, "-m", run_scenes.ENTRY]
    if case == "split_file":
        assert [s["scene"] for s in tsum][:3] == ["016", "021", "022"]
    if case == "shard_1_of_2":
        assert [s["scene"] for s in tsum] == ["021", "025"]
    if case == "prior_root":
        assert jrc == 1 and [s["status"] for s in tsum] == [
            "dry_run", "no_prior", "no_prior"]
        # the latest fine checkpoint by iteration: 12, not 8
        assert targs[targs.index("--prior_checkpoint") + 1] == os.path.join(
            prior_root, "016", "chkpnt_fine_12")
    else:
        assert jrc == 0
    if case == "data_root":
        assert [s["scene"] for s in tsum] == ["016", "021"]


@pytest.mark.parametrize("args,want", [
    ([], 1), (["--batch_size", "4"], 4), (["--batch_size=2", "--seed", "1"],
                                          2), (["--iterations", "9"], 1)])
def test_batch_size_is_read_from_the_forwarded_args(args, want):
    assert run_scenes.batch_size(args) == want


# two stages of a tiny run on the CPU: the first densify, a test split
# (stride 2 on 3 frames: frame 2), a small pool and image
TRAIN_ARGS = ["--", "--num_pts", "400", "--pool_capacity", "4096",
              "--coarse_iterations", "2", "--iterations", "3",
              "--densification_interval", "2", "--densify_from_iter", "1",
              "--checkpoint_iterations", "3", "--max_visible", "2048",
              "--rect_w", "4", "--rect_h", "4", "--chunk", "32",
              "--load_h", "64", "--load_w", "96"]


@pytest.fixture(scope="module")
def two_scenes(tmp_path_factory):
    """Scenes 016 and 021 (two fabricated clips) through run_scenes on
    the CPU, then their phase-2 warm start (``arguments/stage2.py``,
    window 1-2) off the first pass's checkpoints; the printed output of
    each pass."""
    root = tmp_path_factory.mktemp("scenes")
    for seed, scene in enumerate(("016", "021")):
        make_fixture(str(root / "data" / scene), n_frames=3, seed=seed)
    config, _ = merged_preset(
        root, "stage2.py",
        ModelParams={"start_time": 1, "end_time": 2},
        OptimizationParams={"coarse_iterations": 2, "iterations": 3})
    common = ["--data_root", str(root / "data"), "--scenes", "016", "021"]
    printed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("S3G_LPIPS_WEIGHTS", raising=False)
        for argv in (
                ["--output", str(root / "recon"), "--configs", TINY]
                + TRAIN_ARGS + ["--stride", "2"],
                ["--output", str(root / "stage2"), "--configs", config,
                 "--prior_root", str(root / "recon")] + TRAIN_ARGS
                + ["--skip_final_eval"]):
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                rc = run_scenes.main(common + argv, device="cpu")
            printed.append((rc, buf.getvalue()))
    return root, printed


def test_two_scenes_train_and_write_the_summary(two_scenes):
    root, printed = two_scenes
    for out, (rc, text) in zip(("recon", "stage2"), printed):
        assert rc == 0, text
        with open(root / out / "run_summary.json") as f:
            summary = json.load(f)
        assert [(s["scene"], s["status"]) for s in summary] == [
            ("016", "ok"), ("021", "ok")]
        for scene in ("016", "021"):
            assert os.path.isdir(root / out / scene / "chkpnt_fine_3")


def test_the_phase_2_pass_transplants_each_scenes_prior(two_scenes):
    root, printed = two_scenes
    text = printed[1][1]
    for scene in ("016", "021"):
        prior = os.path.join(str(root / "recon"), scene, "chkpnt_fine_3")
        assert f"--prior_checkpoint {prior}" in text
        assert f"transplanting deformation from {prior}" in text


def test_cal_averages_the_two_scenes(two_scenes, capsys):
    root, _ = two_scenes
    capsys.readouterr()
    script("cal").main(["--root", str(root / "recon"), "--split", "test"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" ", 1)[0] for line in lines[:2]] == ["016", "021"]
    assert lines[2] == "--- average over 2 scenes (test) ---"
    avg = ast.literal_eval(lines[3])
    assert set(avg) == {"psnr", "ssim", "masked_psnr", "masked_ssim"}
    assert all(math.isfinite(v) for v in avg.values())
