"""The port's offline tools (``s3gaussian_tpu_torch/tools``) against the
repository's scripts, on the CPU:

  * ``mini_clip.gt_scene`` bit-equal to ``scripts/mini_clip.py``'s at
    density 1 and 4 and with the car knobs; ``train_args`` equal but for
    ``--remat_deform``; a 2-frame 48x64 ``write_clip`` of a small street
    writes the same calibration, poses, LiDAR bytes, masks,
    ``gt_motion.json`` and ``frame_info.json`` as the JAX writer from one
    seed, and each ground-truth render (taken before encoding) equals the
    JAX ``rasterize``'s at the render tolerances of ROADMAP.md (atol 5e-4,
    rtol 1e-4);
  * ``metrics.evaluate`` against ``metrics.py``'s on a few PNG pairs:
    ``results.json`` and ``per_view.json`` PSNR within 1e-6 of its value
    (``metrics.py`` computes in float32, whose PSNR of 17-27 dB is
    resolved to 1-2e-6 dB; the port in float64) and SSIM within 1e-6,
    LPIPS null without weights, and with random VGG weights named by
    ``S3G_LPIPS_WEIGHTS`` within test_torch_lpips.py's atol 1e-5 rtol
    1e-4;
  * ``eval_per_view`` and ``eval_flow_epe`` against the JAX scripts'
    ``main`` on one ``tests/waymo_fixture.py`` clip with a
    ``gt_motion.json`` and one JAX state (a perturbed field, so the flow
    is not zero) saved in both checkpoint formats: per-view PSNR within
    test_torch_eval.py's 0.01 dB plus half a step of the 2-decimal
    rounding the JAX script prints, EPE at test_torch_flow.py's rtol 1e-5;
  * without a card, every tool raises.
"""

import argparse
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

from s3gaussian_tpu import config as jcfg
from s3gaussian_tpu.data.scene import load_scene as j_load_scene
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.ops import rasterizer as j_rasterizer
from s3gaussian_tpu.train import checkpoints as jckpt
from s3gaussian_tpu.train import trainer as jtr
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.data.images import decode_png
from s3gaussian_tpu_torch.train import checkpoints as tckpt
from s3gaussian_tpu_torch.tools import eval_flow_epe as t_flow
from s3gaussian_tpu_torch.tools import eval_per_view as t_per_view
from s3gaussian_tpu_torch.tools import metrics as t_metrics
from s3gaussian_tpu_torch.tools import mini_clip as t_mini_clip
from s3gaussian_tpu_torch.weights import train_state_from_numpy

from test_lpips import rand_vgg_npz
from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny_config.py")
for _p in (REPO, os.path.join(REPO, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import eval_flow_epe as j_flow  # noqa: E402  scripts/eval_flow_epe.py
import eval_per_view as j_per_view  # noqa: E402  scripts/eval_per_view.py
import metrics as j_metrics  # noqa: E402  metrics.py
import mini_clip as j_mini_clip  # noqa: E402  scripts/mini_clip.py

SEED = 6666
BOXES = [{"center0": [20.0, 0.0, 1.0], "vel": [3.0, 0.0, 0.0],
          "half": [12.0, 15.0, 4.0]},
         {"center0": [45.0, 5.0, 1.0], "vel": [0.0, -2.0, 0.0],
          "half": [10.0, 10.0, 4.0]}]


# --------------------------------------------------------------------------
# mini clip
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(density=1.0), dict(density=4.0),
    dict(car_mul=4.0, car_speed=0.1, car_size=2.5)])
def test_gt_scene_equals_jax(kw):
    got = t_mini_clip.gt_scene(np.random.default_rng(3), **kw)
    want = j_mini_clip.gt_scene(np.random.default_rng(3), **kw)
    assert got.keys() == want.keys()
    for k in got:
        if k == "gt_boxes":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("density", [1.0, 4.0])
def test_train_args_equal_jax_but_remat(density):
    args = argparse.Namespace(out="clip", coarse=300, fine=5000, stride=2,
                              reset_interval=3000, h=320, w=480,
                              density=density)
    want = [a for a in j_mini_clip.train_args(args, "m")
            if a != "--remat_deform"]
    assert t_mini_clip.train_args(args, "m") == want
    # every flag parses in the port's CLI
    parser = argparse.ArgumentParser()
    for name in tcfg.GROUPS:
        tcfg.add_group_args(parser, getattr(tcfg, name), name)
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int)
    parser.parse_args(t_mini_clip.train_args(args, "m"))


def small_scene():
    return t_mini_clip.gt_scene(np.random.default_rng(0), n_ground=2000,
                                n_build=1500, n_car=300)


def test_write_clip_matches_jax(tmp_path, monkeypatch):
    scene = small_scene()
    renders = {"jax": [], "port": []}

    def capture(key, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            renders[key].append(np.asarray(out[0]))
            return out
        return wrapped

    monkeypatch.setattr(j_rasterizer, "rasterize",
                        capture("jax", j_rasterizer.rasterize))
    monkeypatch.setattr(t_mini_clip, "rasterize",
                        capture("port", t_mini_clip.rasterize))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_mini_clip.write_clip(str(jdir), scene, 2, 48, 64,
                           np.random.default_rng(1), lidar_cap=1500)
    overflow, n_lidar = t_mini_clip.write_clip(
        str(tdir), scene, 2, 48, 64, np.random.default_rng(1),
        lidar_cap=1500, device="cpu")
    assert overflow["overflow_visible"] == overflow["overflow_pairs"] == 0

    for sub in ("intrinsics", "extrinsics", "ego_pose", "lidar"):
        names = sorted(os.listdir(jdir / sub))
        assert names == sorted(os.listdir(tdir / sub)) and names, sub
        for n in names:
            assert (jdir / sub / n).read_bytes() == \
                (tdir / sub / n).read_bytes(), (sub, n)
    rows = [np.fromfile(tdir / "lidar" / n, np.float32).reshape(-1, 10)
            for n in sorted(os.listdir(tdir / "lidar"))]
    assert sum(len(r) for r in rows) == n_lidar == 3000
    assert all(0 < r[:, 6].sum() < len(r) for r in rows)   # ground labels
    for n in ("gt_motion.json", "frame_info.json"):
        assert json.loads((jdir / n).read_text()) == \
            json.loads((tdir / n).read_text()), n
    from PIL import Image
    masks = sorted(os.listdir(jdir / "dynamic_masks"))
    assert masks == sorted(os.listdir(tdir / "dynamic_masks"))
    n_masked = 0
    for n in masks:
        want = np.asarray(Image.open(jdir / "dynamic_masks" / n))
        got = decode_png((tdir / "dynamic_masks" / n).read_bytes())
        np.testing.assert_array_equal(got, want, err_msg=n)
        n_masked += int(got.any())
    assert n_masked > 0                  # the cars are in view

    assert len(renders["jax"]) == len(renders["port"]) == 6
    images = sorted(os.listdir(tdir / "images"))
    assert images == sorted(os.listdir(jdir / "images"))
    for name, g, w in zip(images, renders["port"], renders["jax"]):
        assert g.shape == w.shape == (3, 48, 64)
        assert g.max() > 0.1, name
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-4, err_msg=name)
        written = decode_png((tdir / "images" / name).read_bytes())
        want8 = (np.clip(g.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(written, want8, err_msg=name)


# --------------------------------------------------------------------------
# metrics.py
# --------------------------------------------------------------------------

# metrics.py computes in float32, the port in float64: PSNR within 1e-6
# of its value (a float32 PSNR of 17-27 dB is resolved to 1-2e-6 dB),
# SSIM within 1e-6
TOL = {"PSNR": dict(rtol=1e-6, atol=0), "SSIM": dict(rtol=0, atol=1e-6)}


def write_method_dirs(root, rng):
    """test/ours/{renders,gt}: three 64x64 PNG pairs, rendered = gt plus
    noise."""
    from PIL import Image
    for i in range(3):
        gt = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        noisy = np.clip(gt + rng.normal(0, 12 * (i + 1), gt.shape), 0, 255)
        for sub, img in (("gt", gt), ("renders", noisy.astype(np.uint8))):
            d = root / "test" / "ours" / sub
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(d / f"{i:05d}.png")


def run_both_metrics(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        write_method_dirs(d, np.random.default_rng(5))
    with contextlib.redirect_stdout(io.StringIO()):
        j_metrics.evaluate([str(jdir)])
        scores = t_metrics.evaluate([str(tdir)], device="cpu")
    out = {}
    for name in ("results.json", "per_view.json"):
        out[name] = [json.loads((d / name).read_text()) for d in (jdir, tdir)]
    assert scores == {str(tdir): out["results.json"][1]}
    return out


def test_metrics_match_jax_without_lpips(tmp_path, monkeypatch):
    monkeypatch.delenv("S3G_LPIPS_WEIGHTS", raising=False)
    out = run_both_metrics(tmp_path)
    want, got = out["results.json"]
    assert got.keys() == want.keys() == {"ours"}
    assert got["ours"]["LPIPS"] is None is want["ours"]["LPIPS"]
    for k, tol in TOL.items():
        np.testing.assert_allclose(got["ours"][k], want["ours"][k], **tol,
                                   err_msg=k)
    want, got = out["per_view.json"]
    for k, tol in TOL.items():
        assert got["ours"][k].keys() == want["ours"][k].keys()
        for name, v in want["ours"][k].items():
            np.testing.assert_allclose(got["ours"][k][name], v, **tol,
                                       err_msg=f"{k} {name}")


def test_metrics_lpips_with_vgg_weights_matches_jax(tmp_path, monkeypatch):
    from s3gaussian_tpu.eval import lpips_jax
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **rand_vgg_npz(np.random.default_rng(0)))
    monkeypatch.setenv("S3G_LPIPS_WEIGHTS", str(path))
    lpips_jax._load_weights.cache_clear()
    try:
        want, got = run_both_metrics(tmp_path)["results.json"]
    finally:
        lpips_jax._load_weights.cache_clear()
    assert want["ours"]["LPIPS"] > 0
    np.testing.assert_allclose(got["ours"]["LPIPS"], want["ours"]["LPIPS"],
                               atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# eval_per_view, eval_flow_epe
# --------------------------------------------------------------------------

def cfg_args(clip, model_path):
    """The cfg_args train.py writes for a tiny run on the fixture: its
    flags and every group's fields with the config file merged in."""
    parser = argparse.ArgumentParser()
    for name in tcfg.GROUPS:
        jcfg.add_group_args(parser, getattr(jcfg, name), name)
    parser.add_argument("--seed", type=int, default=SEED)
    args = parser.parse_args([
        "-s", clip, "--model_path", model_path, "--num_pts", "500",
        "--load_h", "64", "--load_w", "96", "--max_visible", "2048",
        "--rect_w", "4", "--rect_h", "4", "--max_pairs_per_tile", "512"])
    groups = [jcfg.extract_group(getattr(jcfg, n), args)
              for n in ("ModelParams", "PipelineParams", "OptimizationParams",
                        "ModelHiddenParams", "RasterConfig")]
    jcfg.apply_config_file(TINY, *groups)
    dump = dict(vars(args))
    for grp in groups:
        for f in dataclasses.fields(grp):
            if not f.name.startswith("_"):
                dump[f.name] = getattr(grp, f.name)
    return dump, groups


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture clip with gt_motion.json, and one JAX state saved as a
    JAX checkpoint (model path "jax") and as the port's ("port"), each
    beside the same cfg_args."""
    root = tmp_path_factory.mktemp("tools")
    clip = make_fixture(str(root / "clip"), n_frames=3)
    with open(os.path.join(clip, "gt_motion.json"), "w") as f:
        json.dump({"frame_dt": 1.0, "n_frames": 3, "boxes": BOXES}, f)
    paths = {k: str(root / k) for k in ("jax", "port")}
    dump, (model, _, _, hyper, _) = cfg_args(clip, paths["jax"])
    scene = j_load_scene(model)
    noise = np.random.default_rng(1)
    field = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (1 + 0.5 * noise.normal(
            size=np.shape(x))).astype(np.float32),
        init_deformation(jax.random.PRNGKey(SEED), hyper))
    jstate = jtr.init_state(scene.pool, field, scene.aabb)
    for p in paths.values():
        os.makedirs(p)
        with open(os.path.join(p, "cfg_args"), "w") as f:
            f.write(repr(dump))
    jckpt.save_checkpoint(paths["jax"], "fine", 7, jstate)
    port_hyper = tcfg.extract_group(tcfg.ModelHiddenParams,
                                    argparse.Namespace(**dump))
    tckpt.save_checkpoint(paths["port"], "fine", 7, train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), port_hyper,
        device="cpu"))
    return paths


def printed_json(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv, **kw)
    return json.loads(buf.getvalue()), ret


def test_eval_per_view_matches_jax(trained):
    want, _ = printed_json(j_per_view.main, ["--model_path", trained["jax"]])
    shown, got = printed_json(t_per_view.main,
                              ["--model_path", trained["port"]],
                              device="cpu")
    assert got["n_views"] == want["n_views"] == 9
    tol = 0.01 + 0.005            # the metric's, plus the JAX rounding
    for k in ("mean", "median", "p10", "p90"):
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
        assert shown[k] == round(got[k], 2)
    rows = {r["view"]: r for r in want["worst"]}
    assert {r["view"] for r in got["worst"]} == set(rows)
    for r in got["worst"] + got["best"]:
        w = rows[r["view"]]
        assert (r["frame"], r["cam"]) == (w["frame"], w["cam"])
        assert round(r["time"], 4) == w["time"]
        assert abs(r["psnr"] - w["psnr"]) <= tol, r
    assert [r["psnr"] for r in got["worst"]] == sorted(
        r["psnr"] for r in got["worst"])


def test_eval_flow_epe_matches_jax(trained, tmp_path):
    want, _ = printed_json(j_flow.main, ["--model_path", trained["jax"]])
    out = tmp_path / "epe.json"
    shown, got = printed_json(t_flow.main, ["--model_path", trained["port"],
                                            "--out", str(out)],
                              device="cpu")
    assert shown == json.loads(out.read_text()) == got
    assert got.keys() == want.keys() == {"t0_off1", "t1_off1"}
    for key, w in want.items():
        assert got[key].keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, int) or v is None:
                assert got[key][k] == v, (key, k)
            else:
                np.testing.assert_allclose(got[key][k], v, rtol=1e-5,
                                           err_msg=f"{key} {k}")
        assert w["n_dynamic"] > 0 and w["epe_dynamic"] > 0


def test_tools_refuse_without_a_checkpoint(trained, tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "cfg_args").write_text(
        (open(os.path.join(trained["port"], "cfg_args")).read()))
    for main in (t_per_view.main, t_flow.main):
        with pytest.raises(SystemExit, match="no checkpoint"):
            main(["--model_path", str(bare)], device="cpu")


# --------------------------------------------------------------------------
# no card
# --------------------------------------------------------------------------

def test_tools_raise_without_a_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = [
        lambda: t_mini_clip.write_clip(str(tmp_path / "c"), small_scene(), 1,
                                       48, 64, np.random.default_rng(0)),
        lambda: t_metrics.evaluate([str(tmp_path)]),
        lambda: t_per_view.main(["--model_path", trained["port"]]),
        lambda: t_flow.main(["--model_path", trained["port"]]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
