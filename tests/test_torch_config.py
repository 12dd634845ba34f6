"""The port's own config dataclasses keep the JAX package's field names
and defaults (only the TPU-only fields are left out); its native KNN
loader; its entry points put tensors on the card unless asked for the
CPU, and the block functions run where the state lies; the CLI's
``--steps_per_dispatch`` has ``train.py``'s default."""

import argparse
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest

from s3gaussian_tpu import config as jcfg
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.ops import knn as tknn

DROPPED = {
    "ModelParams": set(),
    "ModelHiddenParams": {"remat_deform"},
    "RasterConfig": {"max_pairs_per_tile", "use_pallas", "sort_bf16",
                     "sort_hier", "multicam_serialize", "multicam_scan"},
    "PipelineParams": set(),
    "OptimizationParams": set(),
}
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _defaults(cls):
    return {f.name: (f.default_factory() if f.default is dataclasses.MISSING
                     else f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", sorted(DROPPED))
def test_port_config_fields_keep_jax_defaults(name):
    port, ref = _defaults(getattr(tcfg, name)), _defaults(getattr(jcfg, name))
    assert set(ref) - set(port) == DROPPED[name]
    assert set(port) <= set(ref)
    for k, v in port.items():
        assert v == ref[k], (name, k, v, ref[k])
    if name == "RasterConfig":
        p, r = tcfg.RasterConfig(big_budget=3), jcfg.RasterConfig(big_budget=3)
        assert (p.rect_cap, p.max_pairs, p.n_pair_slots(40)) == \
            (r.rect_cap, r.max_pairs, r.n_pair_slots(40))


def test_knn_native_loader_matches_numpy_search():
    """Above 4,096 points the port calls the native library through its
    own loader; it agrees with the port's numpy Morton-window search."""
    pts = np.random.default_rng(0).uniform(-5, 5, (5000, 3)).astype(
        np.float32)
    native = tknn._native_knn(pts, 3, 32)
    if native is None:
        pytest.skip("native/libs3g_native.so could not be built here")
    want = tknn.mean_knn_dist2(pts[:4000])     # numpy path
    got = tknn._native_knn(pts[:4000], 3, 32)
    # both are Morton-window searches; equal codes may sort in another
    # order and shift a few windows (the criterion of tests/test_native.py)
    rel = np.abs(got - want) / np.maximum(want, 1e-9)
    assert (rel < 1e-5).mean() > 0.99
    assert np.median(rel) < 1e-7
    np.testing.assert_array_equal(tknn.mean_knn_dist2(pts), native)


def _parser(mod):
    parser = argparse.ArgumentParser()
    for name in sorted(DROPPED):
        mod.add_group_args(parser, getattr(mod, name), name)
    return parser


def _actions(parser):
    """flag -> (dest, default, type, action class) of every option."""
    return {s: (a.dest, a.default, a.type, type(a).__name__)
            for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def test_group_flags_match_jax():
    """The same flags with the same defaults, types and actions, but the
    TPU-only fields'."""
    got, want = _actions(_parser(tcfg)), _actions(_parser(jcfg))
    # the Optional fields (use_pallas, sort_bf16, sort_hier) have no flag
    # in either package
    assert set(want) - set(got) == {
        "--remat_deform", "--max_pairs_per_tile", "--multicam_serialize",
        "--multicam_scan"}
    assert set(got) <= set(want)
    for flag, v in got.items():
        assert v == want[flag], flag
    assert got["-s"][0] == "source_path"


ARGV = ["-s", "rel/clip", "-m", "out", "--iterations", "7", "-w",
        "--lambda_dssim", "0.3", "--rect_w", "2", "--no_dx", "--render_process",
        "--load_h", "64", "--pool_capacity", "4096"]


@pytest.mark.parametrize("name", sorted(DROPPED))
def test_extract_group_matches_jax(name):
    got = tcfg.extract_group(getattr(tcfg, name), _parser(tcfg).parse_args(ARGV))
    want = jcfg.extract_group(getattr(jcfg, name),
                              _parser(jcfg).parse_args(ARGV))
    want = {k: v for k, v in dataclasses.asdict(want).items()
            if k not in DROPPED[name]}
    assert dataclasses.asdict(got) == want
    if name == "ModelParams":
        assert got.source_path == str(pathlib.Path("rel/clip").absolute())
        assert got.white_background and got.render_process


def test_bools_are_store_true():
    """A bool is a bare flag, so one that defaults to True (render_process)
    cannot be switched off from the command line."""
    parser = _parser(tcfg)
    assert parser.parse_args([]).render_process is True
    assert parser.parse_args(["--render_process"]).render_process is True
    with pytest.raises(SystemExit):
        parser.parse_args(["--render_process", "False"])
    with pytest.raises(SystemExit):
        parser.parse_args(["--sort_bf16"])         # a TPU-only field


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "arguments").glob("*.py")]
    + ["tests/tiny_config.py"]))
def test_apply_config_file_matches_jax(path):
    """Every config preset sets the same values in both packages; the keys
    of the TPU-only fields are ignored one by one, as is any key a group
    does not know."""
    full = str(ROOT / path)
    got = [getattr(tcfg, n)() for n in ("ModelParams", "PipelineParams",
                                        "OptimizationParams",
                                        "ModelHiddenParams", "RasterConfig")]
    want = [getattr(jcfg, n)() for n in ("ModelParams", "PipelineParams",
                                         "OptimizationParams",
                                         "ModelHiddenParams", "RasterConfig")]
    tcfg.apply_config_file(full, *got)
    jcfg.apply_config_file(full, *want)
    overrides = tcfg.load_config_overrides(full)
    assert overrides == jcfg.load_config_overrides(full) and overrides
    for g, w in zip(got, want):
        name = type(g).__name__
        assert dataclasses.asdict(g) == {
            k: v for k, v in dataclasses.asdict(w).items()
            if k not in DROPPED[name]}, name
        for k in overrides.get(name, {}):
            assert hasattr(g, k) == (k not in DROPPED[name]), k


def test_merge_hparams_sets_only_known_keys():
    opt = tcfg.merge_hparams(tcfg.OptimizationParams(),
                             {"iterations": 9, "not_a_field": 1})
    assert opt.iterations == 9 and not hasattr(opt, "not_a_field")


def _entry_points():
    from s3gaussian_tpu_torch import bench, train_cli, weights
    from s3gaussian_tpu_torch.tools import (eval_flow_epe, eval_per_view,
                                            exchange, metrics, mini_clip,
                                            run_scenes, trained)
    from s3gaussian_tpu_torch.data import (blender, cameras, colmap, scene,
                                           waymo)
    from s3gaussian_tpu_torch.models import deformation, hexplane, pool
    from s3gaussian_tpu_torch.train import checkpoints
    from s3gaussian_tpu_torch.parallel import multihost
    return {"create_from_pcd": pool.create_from_pcd,
            "PoolStats.zeros": pool.PoolStats.zeros,
            "DeformationField": deformation.DeformationField.__init__,
            "init_hexplane": hexplane.init_hexplane,
            "make_camera": cameras.make_camera,
            "pool_from_numpy": weights.pool_from_numpy,
            "deformation_from_numpy": weights.deformation_from_numpy,
            "train_state_from_numpy": weights.train_state_from_numpy,
            "lpips_weights_from_numpy": weights.lpips_weights_from_numpy,
            "read_waymo": waymo.read_waymo,
            "read_colmap_scene": colmap.read_colmap_scene,
            "read_blender_scene": blender.read_blender_scene,
            "load_scene": scene.load_scene,
            "load_ply_pool": checkpoints.load_ply_pool,
            "train_cli.main": train_cli.main,
            "bench.Workload": bench.Workload.__init__,
            "bench.run_workload": bench.run_workload,
            "bench.main": bench.main,
            "mini_clip.write_clip": mini_clip.write_clip,
            "mini_clip.main": mini_clip.main,
            "metrics.evaluate": metrics.evaluate,
            "metrics.main": metrics.main,
            "eval_per_view.main": eval_per_view.main,
            "eval_flow_epe.main": eval_flow_epe.main,
            "trained.load_trained": trained.load_trained,
            "run_scenes.main": run_scenes.main,
            "exchange.import_run": exchange.import_run,
            "exchange.export_run": exchange.export_run,
            "exchange.main": exchange.main,
            "init_multihost": multihost.init_multihost}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _block_functions():
    from s3gaussian_tpu_torch.parallel import data_parallel
    from s3gaussian_tpu_torch.train import graphs, trainer
    return {"train_steps_scan": trainer.train_steps_scan,
            "train_steps_scan_multicam": trainer.train_steps_scan_multicam,
            "parallel_train_steps_scan": data_parallel.parallel_train_steps_scan,
            "parallel_train_steps_scan_multicam":
                data_parallel.parallel_train_steps_scan_multicam,
            "graphs.replay_steps": graphs.replay_steps}


@pytest.mark.parametrize("name", sorted(_block_functions()))
def test_block_functions_run_where_the_state_lies(name):
    """The block functions take no device: they run on the state's (the
    entry points above put it on the card), replaying the captured step
    on a CUDA state and looping the eager step on a CPU one."""
    params = inspect.signature(_block_functions()[name]).parameters
    assert "device" not in params and "state" in params


def test_steps_per_dispatch_defaults_as_train_py():
    """The port's CLI declares ``--steps_per_dispatch`` with ``train.py``'s
    default, read off both sources."""
    import ast

    def flag_default(path):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == "--steps_per_dispatch"):
                return [ast.literal_eval(k.value) for k in node.keywords
                        if k.arg == "default"]
        return None

    want = flag_default(ROOT / "train.py")
    assert want == [10]
    assert flag_default(ROOT / "s3gaussian_tpu_torch" / "train_cli.py") \
        == want
