"""The phase-2 warm start through the port's training CLI against
``train.py``: ``arguments/stage2.py`` and ``arguments/stage2_nvs.py``
chained off a stage-1 run with ``--prior_checkpoint``, both on the CPU,
on a 6-frame fabricated Waymo clip (``tests/torch_cli_pairs.py``).

Stage 1 is the plain reconstruction (the tiny hexplane, ``--end_time
2``: frames 0-2) through both CLIs from one initial field.  After its
first densify the two stage-1 runs differ (``jax.random`` against a
``torch.Generator``), so both stage-2 runs start from one prior: JAX's
``chkpnt_fine_*``, exported by ``scripts/torch_jax_exchange.py`` and
imported into the port by ``tools/exchange.py::import_run``.

Overrides in the merged stage-2 files, the rest of each preset kept
(``original_start_time`` 0): the window 50-99 -> 3-5 of the 6 frames;
the cadence ``coarse_iterations`` 5000 -> 3, ``iterations`` 50000 -> 6;
``stage2_nvs``'s stride 10 -> 2, since stride 10 holds nothing out of a
3-frame window (frame 5 is held out).  The flags set the rest of the
cadence (the first densify at fine step 4, a pool of 4096 rows).

Held for each: the losses up to the first densify (rtol 1e-4; the fine
steps render the transplanted field) and its counts, the logger's keys,
``cameras.json``, the ``cfg_args`` fields with the window and stride,
the final sweep's splits, metric keys and frame files, and
``transplanting deformation`` printed by both.  The port's own chain
(its stage-1 checkpoint into its stage-2 run) carries the field over bit
for bit; a prior whose heads differ from the fresh field's (a
``no_dx`` field and one with a position head) transplants in the port
as in the JAX package.  ``tools/run_scenes.py --prior_root`` pointed at
the imported JAX run gives the stage-2 losses of the same JAX field
converted by hand (``weights.deformation_from_numpy`` written over the
port's stage-1 state).
"""

import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.data import waymo as jwaymo
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.models.pool import create_from_pcd
from s3gaussian_tpu.train import checkpoints as jckpt
from s3gaussian_tpu.train.trainer import init_state as j_init_state
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.config import ModelHiddenParams as THP
from s3gaussian_tpu_torch.config import ModelParams as TMP
from s3gaussian_tpu_torch.config import OptimizationParams as TOpt
from s3gaussian_tpu_torch.config import PipelineParams as TPipe
from s3gaussian_tpu_torch.config import apply_config_file
from s3gaussian_tpu_torch.data import waymo as twaymo
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.tools import run_scenes
from s3gaussian_tpu_torch.tools.exchange import import_run
from s3gaussian_tpu_torch.train import checkpoints as tckpt
from s3gaussian_tpu_torch.train.trainer import init_state as t_init_state
from s3gaussian_tpu_torch.weights import (deformation_from_numpy,
                                          pool_from_numpy)

from torch_cli_pairs import (ARGV, FINE, REPO, TINY, check_cameras,
                             check_cfg_args, check_logger, check_losses,
                             check_sweep, merged_preset, read_log, run_pair)
from test_torch_data import assert_infos_equal
from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES, STAGE1_END = 6, 2
WINDOW = {"start_time": 3, "end_time": 5, "original_start_time": 0}
CADENCE = {"coarse_iterations": 3, "iterations": FINE}
STRIDES = {"stage2.py": 0, "stage2_nvs.py": 2}


def port_hyper(config):
    hp = THP()
    apply_config_file(config, TMP(), TPipe(), TOpt(), hp)
    return hp


def restore_deform(path):
    """The ``deform`` item of a JAX checkpoint, as numpy."""
    import orbax.checkpoint as ocp
    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))["deform"]
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_exchange():
    """``scripts/torch_jax_exchange.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "scripts_torch_jax_exchange",
        os.path.join(REPO, "scripts", "torch_jax_exchange.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Stage 1 through both CLIs on frames 0-2, then the prior both
    stage-2 runs start from: the JAX run exported and imported under
    ``priors/<clip>``.  Returns (clip, JAX checkpoint, the port's own
    checkpoint, the imported prior)."""
    root = tmp_path_factory.mktemp("stage1")
    clip = make_fixture(str(root / "clip"), n_frames=N_FRAMES)
    jout, tout, _, _ = run_pair(
        root, clip, TINY, argv=["--end_time", str(STAGE1_END),
                                "--skip_final_eval"])
    jax_ckpt = os.path.join(jout, f"chkpnt_fine_{FINE}")
    exchange = str(root / "stage1.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_exchange().export(jout, exchange)
        import_run(exchange, str(root / "priors" / "clip"), device="cpu")
    prior = str(root / "priors" / "clip" / f"chkpnt_fine_{FINE}")
    return clip, jax_ckpt, os.path.join(tout, f"chkpnt_fine_{FINE}"), prior


@pytest.fixture(scope="module", params=sorted(STRIDES))
def pair(request, stage1, tmp_path_factory):
    """(preset, jax out, port out, port state, printed outputs) of one
    stage-2 preset's pair of runs from the shared prior."""
    clip, jax_ckpt, _, prior = stage1
    root = tmp_path_factory.mktemp(request.param[:-3])
    config, preset = merged_preset(
        root, request.param,
        ModelParams=dict(WINDOW, stride=STRIDES[request.param]),
        OptimizationParams=CADENCE)
    assert preset["ModelParams"]["start_time"] == 50
    assert preset["OptimizationParams"]["iterations"] == 50000
    return (request.param,) + run_pair(
        root, clip, config, jax_argv=["--prior_checkpoint", jax_ckpt],
        port_argv=["--prior_checkpoint", prior])


def test_both_transplant_the_prior(pair):
    for printed in pair[4]:
        assert "transplanting deformation from " in printed


def test_losses_match_up_to_the_first_densify(pair):
    check_losses(*pair[1:3])


def test_logger_keys_match(pair):
    check_logger(*pair[1:3])


def test_cameras_json_is_identical(pair):
    name = pair[0]
    cams = check_cameras(*pair[1:3])
    # names carry the frame's index in the window, as in train.py
    assert sorted({c["img_name"][:3] for c in cams}) == ["000", "001", "002"]
    if name == "stage2_nvs.py":
        # test cameras first: frame 5, the window's third, is held out
        assert [c["img_name"][:3] for c in cams[:3]] == ["002"] * 3


def test_cfg_args_hold_the_window(pair, stage1):
    cfg = check_cfg_args(*pair[1:3], paths=("model_path", "prior_checkpoint"))
    assert cfg["prior_checkpoint"] == stage1[3]
    for k, v in WINDOW.items():
        assert cfg[k] == v, k
    assert cfg["stride"] == STRIDES[pair[0]] and cfg["no_dx"] is False
    assert (cfg["coarse_iterations"], cfg["iterations"]) == (3, FINE)


def test_sweep_splits_metrics_and_frames_match(pair):
    found = check_sweep(*pair[1:3])
    want = {"train", "full"} | ({"test"} if STRIDES[pair[0]] else set())
    assert set(found) == want


@pytest.mark.parametrize("stride", [0, 2])
def test_reader_times_of_the_later_window_match_jax(stage1, stride):
    """Frames 3-5 normalised over [original_start_time, end_time]."""
    kw = dict(WINDOW, stride=stride, num_pts=300, load_size=(64, 96),
              save_occ_grid=False)
    got = twaymo.read_waymo(stage1[0], device="cpu", **kw)
    want = jwaymo.read_waymo(stage1[0], **kw)
    assert_infos_equal(got, want)
    assert [float(c.time) for c in got.full_cameras[::3]] == pytest.approx(
        [0.6, 0.8, 1.0])


def test_the_port_chain_carries_the_field_bit_for_bit(stage1, tmp_path,
                                                      monkeypatch):
    """The port's stage-1 checkpoint into its own stage-2 run: right
    after the transplant the field equals the prior's, bit for bit,
    across the window change."""
    clip, _, own, _ = stage1
    config, _ = merged_preset(tmp_path, "stage2.py", ModelParams=WINDOW,
                              OptimizationParams=CADENCE)
    seen = []
    orig = tckpt.transplant_deformation

    def transplant(path, state):
        state = orig(path, state)
        seen.append({k: v.clone() for k, v in
                     state.deform.state_dict().items()})
        return state

    monkeypatch.setattr(tckpt, "transplant_deformation", transplant)
    train_cli.main(["-s", clip, "--model_path", str(tmp_path / "out"),
                    "--configs", config] + ARGV
                   + ["--prior_checkpoint", own, "--skip_final_eval"],
                   device="cpu")
    flat = torch.load(os.path.join(own, tckpt.STATE_FILE), weights_only=True)
    want = {k[len("deform."):]: v for k, v in flat.items()
            if k.startswith("deform.")}
    assert len(seen) == 1 and seen[0].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen[0][k], v), k


@pytest.mark.parametrize("prior_no_dx", [True, False])
def test_a_prior_with_other_heads_transplants_as_in_jax(tmp_path,
                                                        prior_no_dx):
    """``static_nvs``'s field (no position head) into ``stage2``'s and
    the reverse: the JAX package loads both, the fresh field's position
    head kept where the prior has none, the prior's dropped where the
    field has none; the port does the same."""
    base = port_hyper(TINY)

    def hps(no_dx):
        kw = {k: getattr(base, k) for k in ("net_width", "kplanes_config",
                                            "multires")}
        return JHP(**kw, no_dx=no_dx), THP(**kw, no_dx=no_dx)

    rng = np.random.default_rng(0)
    jpool = create_from_pcd(rng.random((100, 3)).astype(np.float32),
                            rng.random((100, 3)).astype(np.float32), 256)
    tpool = pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, jpool)),
                            "cpu")
    aabb = np.array([[0, 0, 0], [1, 1, 1]], np.float32)
    states = {}
    for which, key, no_dx in (("prior", 1, prior_no_dx),
                              ("fresh", 2, not prior_no_dx)):
        jhp, thp = hps(no_dx)
        jfield = init_deformation(jax.random.PRNGKey(key), jhp)
        tfield = deformation_from_numpy(
            jax.tree_util.tree_map(np.asarray, jfield), thp, "cpu")
        states[which] = (j_init_state(jpool, jfield, jnp.asarray(aabb)),
                         t_init_state(tpool, tfield, torch.from_numpy(aabb)),
                         thp)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), "fine", 1,
                                  states["prior"][0])
    tpath = tckpt.save_checkpoint(str(tmp_path / "port"), "fine", 1,
                                  states["prior"][1])
    jfresh, tfresh, thp = states["fresh"]
    want = deformation_from_numpy(jax.tree_util.tree_map(
        np.asarray, jckpt.transplant_deformation(jpath, jfresh).deform),
        thp, "cpu")
    fresh_pos = {k: v.clone() for k, v in tfresh.deform.state_dict().items()
                 if k.startswith("heads.pos.")}
    got = tckpt.transplant_deformation(tpath, tfresh).deform
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    # the fresh field's position head stays where the prior has none
    assert bool(fresh_pos) == prior_no_dx
    for k, v in fresh_pos.items():
        assert torch.equal(got.state_dict()[k], v), k


def test_run_scenes_chains_an_imported_jax_run_as_a_hand_converted_prior(
        stage1, tmp_path, monkeypatch):
    """``tools/run_scenes.py --prior_root`` finds the imported JAX stage-1
    run; its stage-2 losses equal those of ``train_cli`` from the same JAX
    field converted by hand and written over the port's stage-1 state."""
    clip, jax_ckpt, own, prior = stage1
    config, _ = merged_preset(tmp_path, "stage2.py", ModelParams=WINDOW,
                              OptimizationParams=CADENCE)
    field = deformation_from_numpy(restore_deform(jax_ckpt),
                                   port_hyper(TINY), "cpu")
    state = tckpt.read_checkpoint(own, DeformationField(
        port_hyper(TINY), torch.Generator().manual_seed(0), "cpu"),
        torch.device("cpu"))[0]
    state.deform.load_state_dict(field.state_dict())
    by_hand = tckpt.save_checkpoint(str(tmp_path / "by_hand"), "fine", FINE,
                                    state)
    monkeypatch.setenv("S3G_LOG_EVERY", "1")
    monkeypatch.delenv("S3G_LPIPS_WEIGHTS", raising=False)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = run_scenes.main(
            ["--data_root", os.path.dirname(clip), "--scenes", "clip",
             "--output", str(tmp_path / "driver"), "--configs", config,
             "--prior_root", os.path.dirname(os.path.dirname(prior)), "--"]
            + ARGV + ["--skip_final_eval"], device="cpu")
        train_cli.main(["-s", clip, "--model_path", str(tmp_path / "hand"),
                        "--configs", config] + ARGV
                       + ["--prior_checkpoint", by_hand, "--skip_final_eval"],
                       device="cpu")
    assert rc == 0
    assert f"transplanting deformation from {prior}" in buf.getvalue()

    def losses(out):
        return [(l["stage"], l["step"], l["Loss"]) for l in read_log(out)
                if "Loss" in l]
    got = losses(str(tmp_path / "driver" / "clip"))
    assert len(got) == 3 + FINE
    assert got == losses(str(tmp_path / "hand"))
