"""A preset through both training CLIs, ``train.py`` and the port's
``train_cli``, on the fabricated Waymo clip, and the comparisons of the
two runs' outputs.  Shared by ``test_torch_presets.py`` and
``test_torch_stage2.py``.

A preset file is merged after argparse in both CLIs, so its values beat
any flag.  ``merged_preset`` writes the real ``arguments/<preset>.py``
with the tiny test hexplane (``tests/tiny_config.py``) and only the
window, the stride and the cadence cut overridden, as
``tests/test_stage2_cli.py::merged_preset`` does.

The runs' cadence puts the first densify in the fine stage (fine step
4, after 3 coarse steps), so the losses compared up to it cover the
deformation field of both stages; after it the split noise differs
(``jax.random`` against a ``torch.Generator``).
"""

import ast
import contextlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest

from s3gaussian_tpu.config import ModelHiddenParams as JHP
from s3gaussian_tpu.config import ModelParams as JMP
from s3gaussian_tpu.config import OptimizationParams as JOpt
from s3gaussian_tpu.config import PipelineParams as JPipe
from s3gaussian_tpu.config import apply_config_file as j_apply_config_file
from s3gaussian_tpu.eval import lpips_jax
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.weights import deformation_from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny_config.py")
SEED = 6666
COARSE, FINE, FIRST_DENSIFY = 3, 6, ("fine", 4)
# the cadence of every pair: a small pool (the default 2^16 rows make a
# sweep render cost a train step), the first densify at fine step 4
ARGV = ["--num_pts", "500", "--pool_capacity", "4096",
        "--coarse_iterations", str(COARSE), "--iterations", str(FINE),
        "--densification_interval", "4", "--densify_from_iter", "2",
        "--opacity_reset_interval", "1000",
        "--checkpoint_iterations", str(FINE),
        "--max_visible", "2048", "--rect_w", "4", "--rect_h", "4",
        "--chunk", "32", "--load_h", "64", "--load_w", "96",
        "--seed", str(SEED)]
# caps the jnp compositor's chunks per tile, a field the port does not
# have; the fixture's tiles stay under it
JAX_ARGV = ["--max_pairs_per_tile", "512"]
# the TPU-only fields of cfg_args
TPU_ONLY = {"remat_deform", "max_pairs_per_tile", "use_pallas", "sort_bf16",
            "sort_hier", "multicam_serialize", "multicam_scan"}
METRICS = {"psnr", "ssim", "masked_psnr", "masked_ssim", "lpips"}


def merged_preset(tmp_path, name, **groups):
    """``arguments/<name>`` with the tiny hexplane; ``groups`` maps a
    config group to the values that replace the preset's (the window,
    the stride, the cadence).  Returns (path, the preset's own groups)."""
    preset, tiny = {}, {}
    with open(os.path.join(REPO, "arguments", name)) as f:
        exec(f.read(), preset)
    with open(TINY) as f:
        exec(f.read(), tiny)
    hp = dict(tiny["ModelHiddenParams"])
    hp.update(preset.get("ModelHiddenParams", {}))
    merged = {"ModelHiddenParams": hp}
    for group in ("ModelParams", "OptimizationParams"):
        if group in preset or group in groups:
            merged[group] = dict(preset.get(group, {}), **groups.get(group,
                                                                      {}))
    path = os.path.join(str(tmp_path), f"merged_{name}")
    with open(path, "w") as f:
        for group, values in merged.items():
            f.write(f"{group} = {values!r}\n")
    return path, {k: v for k, v in preset.items() if k in (
        "ModelParams", "OptimizationParams", "ModelHiddenParams")}


def jax_hyper(config):
    hp = JHP()
    j_apply_config_file(config, JMP(), JPipe(), JOpt(), hp)
    return hp


def same_field(config):
    """A ``make_deformation`` for the port that gives the JAX CLI's
    initial field, built from ``config``'s ModelHiddenParams (with
    ``no_dx`` the JAX field has no position head, nor the port's)."""
    def make(hyper, seed, device):
        field = jax.tree_util.tree_map(np.asarray, init_deformation(
            jax.random.PRNGKey(seed), jax_hyper(config)))
        return deformation_from_numpy(field, hyper, device)
    return make


def run_pair(root, src, config, argv=(), jax_argv=(), port_argv=()):
    """Both CLIs on ``src`` with ``--configs config``, S3G_LOG_EVERY=1,
    no LPIPS weights and the same initial field.  Returns (jax out, port
    out, the port's final state, the printed output of each)."""
    sys.path.insert(0, REPO)
    import train as jax_cli

    jout, tout = os.path.join(str(root), "jax"), os.path.join(str(root),
                                                              "port")
    common = ["-s", src, "--configs", config] + ARGV + list(argv)
    printed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        mp.delenv("S3G_LPIPS_WEIGHTS", raising=False)
        lpips_jax._load_weights.cache_clear()
        mp.setattr(train_cli, "make_deformation", same_field(config))
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            jax_cli.main(["--model_path", jout] + common + JAX_ARGV
                         + list(jax_argv))
        printed.append(buf.getvalue())
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            state = train_cli.main(["--model_path", tout] + common
                                   + list(port_argv), device="cpu")
        printed.append(buf.getvalue())
    return jout, tout, state, printed


def read_log(out):
    with open(os.path.join(out, "logger.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_cfg_args(out):
    with open(os.path.join(out, "cfg_args")) as f:
        return ast.literal_eval(f.read())


def losses_to_first_densify(log):
    """{(stage, step): Loss} of every logged step up to the first
    densify, which logs after its step's Loss line."""
    first = next((l["stage"], l["step"]) for l in log if "densify" in l)
    order = {"coarse": 0, "fine": 1}
    return {(l["stage"], l["step"]): l["Loss"] for l in log
            if "Loss" in l and (order[l["stage"]], l["step"])
            <= (order[first[0]], first[1])}


def first_densify(log):
    return next((l["stage"], l["step"], l["densify"]) for l in log
                if "densify" in l)


def log_shape(log):
    return [(l.get("stage"), l.get("step"), sorted(l),
             sorted(l.get("densify", {}))) for l in log]


def sweep(out, step):
    """{split: (metric keys, the frame files written)} of the sweep at
    ``step``."""
    mdir = os.path.join(out, "eval", "metrics")
    found = {}
    for name in sorted(os.listdir(mdir)):
        s, _, split, _ = name.split("_")
        if s == str(step):
            with open(os.path.join(mdir, name)) as f:
                keys = set(json.load(f))
            frames = sorted(os.listdir(os.path.join(
                out, "eval", f"{split}_set_{step}")))
            found[split] = (keys, frames)
    return found


def check_losses(jout, tout):
    """Every logged Loss up to the first densify within rtol 1e-4, and
    that densify's counts equal."""
    jlog, tlog = read_log(jout), read_log(tout)
    want, got = losses_to_first_densify(jlog), losses_to_first_densify(tlog)
    assert sorted(got) == sorted(want) == (
        [("coarse", s) for s in range(1, COARSE + 1)]
        + [("fine", s) for s in range(1, FIRST_DENSIFY[1] + 1)])
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=1e-4)
    assert first_densify(tlog) == first_densify(jlog)
    assert first_densify(tlog)[:2] == FIRST_DENSIFY


def check_logger(jout, tout):
    """The logger's keys and cadence equal; the port's losses finite."""
    jlog, tlog = read_log(jout), read_log(tout)
    assert log_shape(tlog) == log_shape(jlog)
    for line in tlog:
        if "Loss" in line:
            assert np.isfinite(line["Loss"]) and line["nan_skips"] == 0
            assert line["ovf_pairs"] == 0
    return tlog


def check_cameras(jout, tout):
    with open(os.path.join(jout, "cameras.json")) as f:
        want = f.read()
    with open(os.path.join(tout, "cameras.json")) as f:
        assert f.read() == want
    return json.loads(want)


def check_cfg_args(jout, tout, paths=("model_path",)):
    """The port's cfg_args fields equal the JAX CLI's but the ``paths``
    of each run's own; the JAX CLI has the TPU-only fields besides."""
    jcfg, tcfg = read_cfg_args(jout), read_cfg_args(tout)
    assert set(jcfg) - set(tcfg) == TPU_ONLY and set(tcfg) <= set(jcfg)
    for k, v in tcfg.items():
        if k not in paths:
            assert v == jcfg[k], k
    return tcfg


def check_sweep(jout, tout):
    """The final sweeps' splits, metric keys and frame files equal."""
    want, got = sweep(jout, FINE), sweep(tout, FINE)
    assert got == want
    for keys, frames in got.values():
        assert keys == METRICS and frames
    return got
