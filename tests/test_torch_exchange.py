"""Checkpoint interchange between the JAX package and the port, on the CPU:
a JAX run (``train.py`` on the fabricated Waymo clip with
``tests/tiny_config.py``, 3 coarse + 6 fine steps, a densify at fine
step 4, the run of ``scripts/torch_make_exchange_fixture.py``) exported
by ``scripts/torch_jax_exchange.py`` and imported by
``s3gaussian_tpu_torch.tools.exchange``, and back.

Held:
  (a) the imported state equals ``weights.train_state_from_numpy`` of
      the JAX tree, bit for bit and dtype for dtype: pool (dead rows
      included), field, both moments, count, statistics, step, aabb,
      nan_skips;
  (b) JAX -> port -> JAX and port -> JAX -> port give every array back
      bit for bit;
  (c) three fine ``train_step``s from the imported state against three
      JAX steps from the orbax state (``test_torch_train.py``'s
      tolerances after three steps);
  (d) ``--eval_only`` of the port's CLI on the imported run against
      ``train.py --eval_only`` on the JAX run: the same splits and
      metric keys, values within ``test_torch_eval.py``'s sweep
      tolerances (psnr 0.01, ssim and lpips 1e-3);
  (e) the refusals, each naming what it refuses;
  (f) the committed ``tests/fixtures/jax_exchange_tiny.npz`` is what the
      generator makes from this run (the paths in ``cfg_args`` aside),
      and its camera renders through the port within the render
      tolerance (atol 5e-4, rtol 1e-4) of the JAX package's render.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu import config as jcfg
from s3gaussian_tpu.data.scene import load_scene as j_load_scene
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.train import checkpoints as jckpt
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.data.scene import load_scene as t_load_scene
from s3gaussian_tpu_torch.render.renderer import render
from s3gaussian_tpu_torch.tools import eval_per_view
from s3gaussian_tpu_torch.tools import exchange as tx
from s3gaussian_tpu_torch.train import checkpoints as tckpt
from s3gaussian_tpu_torch.train import trainer as ttr
from s3gaussian_tpu_torch.utils import exchange_file as xf
from s3gaussian_tpu_torch.weights import train_state_from_numpy

from test_torch_train import assert_aux_match, assert_states_match
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "jax_exchange_tiny.npz")


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = script("torch_make_exchange_fixture")
xj = script("torch_jax_exchange")
# the port's CLI has no max_pairs_per_tile; --eval_only ignores the rest
PORT_ARGV = [a for i, a in enumerate(gen.ARGV)
             if "--max_pairs_per_tile" not in gen.ARGV[max(i - 1, 0):i + 1]]


def quiet(fn, *a, **k):
    """``fn``'s result and what it printed."""
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        res = fn(*a, **k)
    return res, buf.getvalue()


def cfg_args(model_path):
    with open(os.path.join(model_path, "cfg_args")) as f:
        return ast.literal_eval(f.read())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run, its exchange file, its import into the port (with the
    printed output), the groups of its cfg_args."""
    root = tmp_path_factory.mktemp("exchange")
    clip, jax_run = gen.train(str(root))
    exchange = str(root / "jax.npz")
    quiet(xj.export, jax_run, exchange)
    imported = str(root / "imported")
    state, printed = quiet(tx.import_run, exchange, imported, device="cpu")
    ns = SimpleNamespace(**cfg_args(jax_run))
    return SimpleNamespace(
        root=root, clip=clip, jax_run=jax_run, exchange=exchange,
        imported=imported, state=state, printed=printed,
        jax_ckpt=os.path.join(jax_run, f"chkpnt_fine_{gen.FINE}"),
        port_ckpt=os.path.join(imported, f"chkpnt_fine_{gen.FINE}"),
        jgroups={c: jcfg.extract_group(getattr(jcfg, c), ns)
                 for c in tcfg.GROUPS},
        tgroups={c: tcfg.extract_group(getattr(tcfg, c), ns)
                 for c in tcfg.GROUPS})


@pytest.fixture(scope="module")
def jax_state(run):
    """The JAX run's checkpoint restored against its own template, and the
    JAX scene."""
    model = run.jgroups["ModelParams"]
    scene = j_load_scene(model, pool_capacity=model.pool_capacity or None)
    template = jtr.init_state(scene.pool, init_deformation(
        jax.random.PRNGKey(0), run.jgroups["ModelHiddenParams"]), scene.aabb)
    state, stage, it = jckpt.load_checkpoint(run.jax_ckpt, template)
    assert (stage, it) == ("fine", gen.FINE)
    return state, scene


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def assert_tensors_equal(got, want):
    """Two flat dicts of tensors: the same keys, dtypes and bits."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def orbax_arrays(path):
    """Every leaf of a JAX checkpoint, restored with no template."""
    import orbax.checkpoint as ocp
    tree = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    return {k: np.asarray(v) for k, v in xf.flatten(tree).items()}


def saved_tensors(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, tckpt.STATE_FILE),
                      weights_only=True)


# --------------------------------------------------------------------------
# (a), (b)
# --------------------------------------------------------------------------

def test_a_jax_checkpoint_reaches_the_port_bit_for_bit(run, jax_state):
    want = train_state_from_numpy(np_tree(jax_state[0]),
                                  run.tgroups["ModelHiddenParams"], "cpu")
    assert_tensors_equal(tckpt.state_tensors(run.state),
                         tckpt.state_tensors(want))
    assert_tensors_equal(saved_tensors(run.port_ckpt),
                         tckpt.state_tensors(want))
    # a non-trivial state: moments, statistics, dead rows, a densify
    s = run.state
    assert int(s.adam.count) == gen.FINE and int(s.step) == gen.FINE
    assert float(s.adam.nu["deform"]["grid.scale0_plane0"].abs().max()) > 0
    assert float(s.stats.denom.max()) > 0
    assert 0 < int(s.pool.n_alive) < s.pool.capacity
    assert tckpt.read_stage(run.port_ckpt) == ("fine", gen.FINE)
    # cfg_args: the JAX run's, model_path rewritten, JAX-only fields kept
    got, want = cfg_args(run.imported), cfg_args(run.jax_run)
    assert got.pop("model_path") == run.imported
    want.pop("model_path")
    assert got == want
    assert set(tx.JAX_ONLY) <= set(got)
    assert "JAX-only fields kept in cfg_args" in run.printed
    assert "max_pairs_per_tile=512" in run.printed
    assert "--pool_capacity 2048" in run.printed


def test_b_jax_port_jax_round_trip_is_bit_identical(run, tmp_path):
    back = str(tmp_path / "port.npz")
    quiet(tx.export_run, run.imported, back, device="cpu")
    # the port's file holds the JAX file's arrays
    a, meta_a = xf.read(run.exchange)
    b, meta_b = xf.read(back)
    assert_arrays_equal(b, a)
    assert (meta_a["written_by"], meta_b["written_by"]) == (
        "s3gaussian_tpu", "s3gaussian_tpu_torch")
    assert (meta_b["stage"], meta_b["iteration"]) == ("fine", gen.FINE)
    path = quiet(xj.import_, back, str(tmp_path / "jax"))[0]
    assert_arrays_equal(orbax_arrays(path), orbax_arrays(run.jax_ckpt))
    assert tckpt.read_stage(path) == ("fine", gen.FINE)


def test_b_port_jax_port_round_trip_is_bit_identical(run, tmp_path):
    """From a state the port trained: one port step from the import,
    saved by the port's ``save_checkpoint``."""
    thp = run.tgroups["ModelHiddenParams"]
    cpu = torch.device("cpu")
    state = tckpt.read_checkpoint(run.port_ckpt, tx._field(thp, "cpu"),
                                  cpu)[0]
    model = run.tgroups["ModelParams"]
    scene = t_load_scene(model, pool_capacity=model.pool_capacity,
                         device="cpu")
    state, _ = ttr.train_step(
        state, scene.get_train_cameras()[1], "fine", 3, thp,
        tcfg.OptimizationParams(), tcfg.PipelineParams(),
        dataclasses.replace(run.tgroups["RasterConfig"], pair_budget=1 << 16),
        5.0, torch.zeros(3))
    own = str(tmp_path / "own")
    os.makedirs(own)
    shutil.copyfile(os.path.join(run.imported, "cfg_args"),
                    os.path.join(own, "cfg_args"))
    src = tckpt.save_checkpoint(own, "fine", gen.FINE + 1, state)
    assert not torch.equal(state.pool.xyz, run.state.pool.xyz)

    first = str(tmp_path / "port.npz")
    quiet(tx.export_run, own, first, device="cpu")
    quiet(xj.import_, first, str(tmp_path / "jax"))
    second = str(tmp_path / "jax.npz")
    quiet(xj.export, str(tmp_path / "jax"), second)
    back, _ = quiet(tx.import_run, second, str(tmp_path / "port"),
                    device="cpu")
    assert_tensors_equal(tckpt.state_tensors(back), saved_tensors(src))
    dst = os.path.join(str(tmp_path / "port"), f"chkpnt_fine_{gen.FINE + 1}")
    assert_tensors_equal(saved_tensors(dst), saved_tensors(src))
    assert tckpt.read_stage(dst) == ("fine", gen.FINE + 1)


# --------------------------------------------------------------------------
# (c), (d)
# --------------------------------------------------------------------------

def test_c_three_fine_steps_from_the_imported_state_match_jax(run,
                                                              jax_state):
    """The hexplane in float32 on both sides, as in test_torch_train.py;
    the pair budget cut to 2^16 (the jnp compositor's arrays)."""
    jstate, jscene = jax_state
    jhp = dataclasses.replace(run.jgroups["ModelHiddenParams"],
                              grid_compute_bf16=False)
    thp = dataclasses.replace(run.tgroups["ModelHiddenParams"],
                              grid_compute_bf16=False)
    jc = dataclasses.replace(run.jgroups["RasterConfig"],
                             pair_budget=1 << 16)
    tc = dataclasses.replace(run.tgroups["RasterConfig"], pair_budget=1 << 16)
    model = run.tgroups["ModelParams"]
    tscene = t_load_scene(model, pool_capacity=model.pool_capacity,
                          device="cpu")
    ts = tckpt.read_checkpoint(run.port_ckpt, tx._field(thp, "cpu"),
                               torch.device("cpu"))[0]
    js = jtr.clone_state(jstate)
    jopt, topt = jcfg.OptimizationParams(), tcfg.OptimizationParams()
    jpipe, tpipe = jcfg.PipelineParams(), tcfg.PipelineParams()
    for i in (0, 4, 8):
        js, jaux = jtr.train_step(js, jscene.get_train_cameras()[i], "fine",
                                  3, jhp, jopt, jpipe, jc, 5.0, jnp.zeros(3))
        ts, taux = ttr.train_step(ts, tscene.get_train_cameras()[i], "fine",
                                  3, thp, topt, tpipe, tc, 5.0,
                                  torch.zeros(3))
    assert_aux_match(taux, jaux)
    assert int(taux["n_pairs"]) > 0
    assert_states_match(ts, np_tree(js), 1e-4)


def sweep_metrics(model_path):
    """{split: metrics} of the one sweep under ``model_path``."""
    mdir = os.path.join(model_path, "eval", "metrics")
    out = {}
    for name in sorted(os.listdir(mdir)):
        with open(os.path.join(mdir, name)) as f:
            out[name.split("_")[2]] = json.load(f)
    return out


def test_d_eval_only_on_the_imported_run_matches_train_py(run, tmp_path,
                                                          monkeypatch):
    import train as jax_cli

    jax_run = str(tmp_path / "jax")
    shutil.copytree(run.jax_run, jax_run)
    port_run = str(tmp_path / "port")
    quiet(tx.import_run, run.exchange, port_run, device="cpu")
    monkeypatch.delenv("S3G_LPIPS_WEIGHTS", raising=False)
    config = os.path.join(str(run.root), "tiny_config.py")
    common = ["-s", run.clip, "--configs", config, "--eval_only"]
    quiet(jax_cli.main, common + ["--model_path", jax_run] + gen.ARGV)
    quiet(train_cli.main, common + ["--model_path", port_run] + PORT_ARGV,
          device="cpu")
    want, got = sweep_metrics(jax_run), sweep_metrics(port_run)
    assert sorted(got) == sorted(want) == ["full", "train"]
    for split, w in want.items():
        assert got[split].keys() == w.keys()
        for k, v in w.items():
            # lpips is None in both without LPIPS weights
            if v is None or got[split][k] is None:
                assert got[split][k] is v is None, (split, k)
                continue
            tol = 0.01 if "psnr" in k else 1e-3
            assert abs(got[split][k] - v) <= tol, (split, k, got[split][k], v)
        assert np.isfinite(got[split]["psnr"])


def test_d_offline_tools_take_the_imported_run(run):
    got, _ = quiet(eval_per_view.main, ["--model_path", run.imported],
                   device="cpu")
    assert got["n_views"] == 9 and np.isfinite(got["mean"])


# --------------------------------------------------------------------------
# (e) refusals
# --------------------------------------------------------------------------

def rewrite(src, dst, drop=(), put=None, cfg=None, version=None, bf16=()):
    """A copy of the exchange file ``src`` at ``dst``, with keys dropped,
    arrays put, cfg_args fields replaced, another version, or keys
    marked bfloat16."""
    arrays, meta = xf.read(src)
    for k in drop:
        del arrays[k]
    arrays.update(put or {})
    args = ast.literal_eval(meta["cfg_args"])
    args.update(cfg or {})
    xf.write(dst, arrays, stage=meta["stage"], iteration=meta["iteration"],
             cfg_args=repr(args), written_by=meta["written_by"])
    if version is not None or bf16:
        with np.load(dst) as z:
            d = dict(z)
        if version is not None:
            d["meta/version"] = np.array(version)
        d["meta/bf16_keys"] = np.array(list(bf16), dtype=str)
        np.savez(dst, **d)
    return dst


REFUSALS = {
    "version": (dict(version=2), "meta/version 2 is not a version"),
    "missing": (dict(drop=["adam/nu/deform/mlp/pos/l2/b"]),
                "missing key adam/nu/deform/mlp/pos/l2/b"),
    "extra": (dict(put={"deform/mlp/pos/l3/b": np.zeros(3, np.float32)}),
              "extra key deform/mlp/pos/l3/b"),
    "heads": (dict(cfg={"no_dx": True}), r"extra key \S*deform/mlp/pos/"),
    "dtype": (dict(put={"step": np.array(6, np.int64)}),
              "step has dtype int64, the run int32"),
    "bf16": (dict(bf16=["aabb"]), "aabb is bfloat16"),
    "jax_only": (dict(cfg={"use_pallas": False}), "max_pairs_per_tile=512"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_e_the_port_refuses(run, tmp_path, case):
    kw, match = REFUSALS[case]
    bad = rewrite(run.exchange, str(tmp_path / "bad.npz"), **kw)
    with pytest.raises(ValueError, match=match):
        quiet(tx.import_run, bad, str(tmp_path / "out"), device="cpu")
    assert not os.path.exists(tmp_path / "out" / f"chkpnt_fine_{gen.FINE}")


@pytest.mark.parametrize("case", ["version", "missing", "heads"])
def test_e_the_jax_half_refuses(run, tmp_path, case):
    kw, match = REFUSALS[case]
    bad = rewrite(run.exchange, str(tmp_path / "bad.npz"), **kw)
    with pytest.raises(ValueError, match=match):
        quiet(xj.import_, bad, str(tmp_path / "out"))


def test_e_a_pool_capacity_the_scene_does_not_give_is_refused(run):
    """The import names the capacity the run needs; a CLI run whose reader
    sizes the pool otherwise refuses to load it, naming the shapes."""
    argv = ["-s", run.clip, "--model_path", str(run.root / "resized"),
            "--configs", os.path.join(str(run.root), "tiny_config.py"),
            "--start_checkpoint", run.port_ckpt] + PORT_ARGV
    cap = argv.index("--pool_capacity") + 1
    argv[cap] = "4096"
    with pytest.raises(ValueError, match=r"pool.xyz has shape \(2048, 3\), "
                       r"the state \(4096, 3\)"):
        quiet(train_cli.main, argv, device="cpu")
    assert "(--pool_capacity 2048 " in run.printed


# --------------------------------------------------------------------------
# (f) the committed fixture
# --------------------------------------------------------------------------

PATHS = ("source_path", "model_path", "configs")


def test_f_the_committed_fixture_is_what_the_generator_makes(run):
    made = gen.fixture_arrays(run.jax_run)
    with np.load(FIXTURE, allow_pickle=False) as z:
        committed = dict(z)
    assert sorted(made) == sorted(committed)
    for k, v in committed.items():
        if k != "exchange":
            assert made[k].dtype == v.dtype, k
            np.testing.assert_array_equal(made[k], v, err_msg=k)
    got, want = (xf.read(io.BytesIO(d["exchange"].tobytes()))
                 for d in (made, committed))
    assert_arrays_equal(got[0], want[0])
    g, w = (ast.literal_eval(m["cfg_args"]) for m in (got[1], want[1]))
    assert {k: v for k, v in g.items() if k not in PATHS} == {
        k: v for k, v in w.items() if k not in PATHS}
    assert {k: v for k, v in got[1].items() if k != "cfg_args"} == {
        k: v for k, v in want[1].items() if k != "cfg_args"}


def fixture_camera(z, device):
    def t(k):
        return torch.as_tensor(z[f"camera/{k}"], device=device)
    return Camera(world_view=t("world_view"), full_proj=t("full_proj"),
                  campos=t("campos"), time=t("time"),
                  fovx=float(z["camera/fovx"]), fovy=float(z["camera/fovy"]),
                  image_height=int(z["camera/height"]),
                  image_width=int(z["camera/width"]))


def test_f_the_fixture_renders_in_the_port_as_in_jax(tmp_path):
    """What ``chip_smoke.py`` phase 15b does on the card, on the CPU."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        z = dict(z)
    exchange = tmp_path / "run.npz"
    exchange.write_bytes(z["exchange"].tobytes())
    state, _ = quiet(tx.import_run, str(exchange), str(tmp_path / "run"),
                     device="cpu")
    ns = SimpleNamespace(**cfg_args(str(tmp_path / "run")))
    with torch.no_grad():
        out = render(fixture_camera(z, "cpu"), state.pool, state.deform,
                     tcfg.extract_group(tcfg.PipelineParams, ns),
                     torch.zeros(3), state.aabb, int(z["sh_degree"]), "fine",
                     cfg=tcfg.extract_group(tcfg.RasterConfig, ns))
    assert out["render"].shape == z["render/rgb"].shape
    assert out["depth"].shape == z["render/depth"].shape
    np.testing.assert_allclose(out["render"].numpy(), z["render/rgb"],
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(out["depth"].numpy(), z["render/depth"],
                               atol=5e-4, rtol=1e-4)
    assert z["render/rgb"].max() > 0.05
    assert os.path.getsize(FIXTURE) < 2 << 20


def test_the_jax_half_imports_no_torch():
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import importlib.util\n"
            "spec = importlib.util.spec_from_file_location('x', "
            f"{os.path.join(REPO, 'scripts', 'torch_jax_exchange.py')!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "import s3gaussian_tpu.train.checkpoints, orbax.checkpoint\n"
            "assert not [k for k in sys.modules if k.startswith('torch') "
            "and sys.modules[k] is not None]\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
