"""The port's rig render and evaluation sweep against the JAX package's,
from one state carried across (pool from the JAX ``create_from_pcd``,
deformation field initialised by JAX, both through ``weights``), on the
CPU: the jnp compositor on the JAX side, the plain one on the port's.

  * ``render_multicam`` (fine with the decomposition, fine with
    ``convert_SHs_python`` on and off, coarse against JAX's
    ``multicam_scan`` core) at the
    render tolerances of ROADMAP.md: images/depth atol 5e-4 rtol 1e-4,
    radii, visibility and counts exact, dx atol 1e-5;
  * ``render_pixels`` over a split laid out as rigs (grouped) and one
    that is not (per camera): per-view psnr within 0.01 dB, ssim, masked
    ssim and LPIPS (the committed fixture weights) within 1e-3; uint8
    frames equal but for ±1 on at most 0.1% of the values; depths atol
    5e-4 rtol 1e-4; the same keys;
  * the dynamic/static PLY split at the probe view: the same rows;
  * ``do_evaluation``: the same JSON keys and file layout, and with
    imageio blocked on the port's side, PNGs that decode
    (``data/images.py::decode_png``) to the pixels JAX wrote through PIL;
    with ``write=False`` the same results and no file.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams, PipelineParams
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.data.cameras import stack_cameras
from s3gaussian_tpu.eval import lpips_jax
from s3gaussian_tpu.eval import video as j_video
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.models.pool import create_from_pcd as j_create_from_pcd
from s3gaussian_tpu.render.renderer import render_multicam as j_render_multicam
from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.data.images import decode_png
from s3gaussian_tpu_torch.eval import video as t_video
from s3gaussian_tpu_torch.render.renderer import render as t_render
from s3gaussian_tpu_torch.render.renderer import \
    render_multicam as t_render_multicam
from s3gaussian_tpu_torch.weights import deformation_from_numpy, pool_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
LPIPS_FIXTURE = os.path.join(HERE, "fixtures", "lpips_alex_fixture.npz")
H, W = 64, 96
N, CAP = 260, 288
HP = dict(net_width=16, multires=[1, 2], grid_compute_bf16=False,
          kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                          "output_coordinate_dim": 8,
                          "resolution": [8, 8, 8, 5]})
AABB = np.array([[6.0, 6.0, 9.0], [-6.0, -6.0, 0.0]], np.float32)
# the jnp compositor caps each tile at max_pairs_per_tile, which every
# tile here stays far under
J_CFG = JRasterConfig(max_visible=CAP, pair_budget=1 << 16,
                      max_pairs_per_tile=512)
T_CFG = RasterConfig(max_visible=CAP, pair_budget=1 << 16)
BG = np.array([0.1, 0.2, 0.3], np.float32)
YAWS = (-20.0, 0.0, 20.0)
RIG_TIMES = (0.2, 0.5, 0.8)          # 3 rigs of 3 cameras: grouped
LOOSE_TIMES = (0.1, 0.3, 0.6, 0.9)   # 4 cameras: per camera


class Side:
    """One package's state and cameras."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _scene():
    rng = np.random.default_rng(0)
    tan = np.tan(0.5)
    z = rng.uniform(1.5, 8.0, N)
    pts = np.stack([rng.uniform(-0.9, 0.9, N) * tan * z,
                    rng.uniform(-0.9, 0.9, N) * tan * z, z], 1)
    jpool = j_create_from_pcd(pts.astype(np.float32),
                              rng.random((N, 3)).astype(np.float32), CAP)
    jpool.features_rest = jnp.asarray(
        0.2 * rng.normal(size=jpool.features_rest.shape), jnp.float32)
    jpool.opacity = jnp.asarray(rng.normal(0.5, 1.0, (CAP, 1)), jnp.float32)
    jpool.alive = jpool.alive & jnp.asarray(rng.random(CAP) > 0.05)
    hp = ModelHiddenParams(**HP)
    deform = init_deformation(jax.random.PRNGKey(0), hp)
    tpool = pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, jpool)),
                            device="cpu")
    tdeform = deformation_from_numpy(
        jax.tree_util.tree_map(np.asarray, deform), hp, device="cpu")
    return jpool, deform, hp, tpool, tdeform


def _camera_pair(yaw_deg, time, image=None, mask=None):
    yaw = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    T = np.array([0.2, -0.1, 0.3])
    return (j_make_camera(R, T, 1.0, 0.8, W, H, time=time, image=image,
                          dynamic_mask=mask),
            t_make_camera(R, T, 1.0, 0.8, W, H, time=time, image=image,
                          dynamic_mask=mask, device="cpu"))


def _split(times, tpool, tdeform, rng, empty_mask_at=None):
    """Cameras of ``times`` x YAWS, frame-major, each with a ground truth
    made from the port's render plus noise and a dynamic mask (one left
    empty); (jax cameras, port cameras)."""
    jcams, tcams = [], []
    for i, (t, yaw) in enumerate((t, y) for t in times for y in YAWS):
        _, tc = _camera_pair(yaw, t)
        with torch.no_grad():
            img = t_render(tc, tpool, tdeform, PipelineParams(),
                           torch.from_numpy(BG), torch.from_numpy(AABB), 3,
                           cfg=T_CFG)["render"]
        img = np.clip(img.permute(1, 2, 0).numpy()
                      + rng.normal(0, 0.03, (H, W, 3)), 0, 1)
        mask = np.zeros((H, W), bool)
        if i != empty_mask_at:
            y0, x0 = rng.integers(0, H - 20), rng.integers(0, W - 30)
            mask[y0:y0 + 20, x0:x0 + 30] = True
        jc, tc = _camera_pair(yaw, t, img.astype(np.float32), mask)
        jcams.append(jc)
        tcams.append(tc)
    return jcams, tcams


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Both packages' render_pixels on a grouped and an ungrouped split
    and do_evaluation over them, with the LPIPS fixture weights."""
    jpool, jdeform, hp, tpool, tdeform = _scene()
    rng = np.random.default_rng(1)
    grouped = _split(RIG_TIMES, tpool, tdeform, rng, empty_mask_at=4)
    loose = _split(LOOSE_TIMES, tpool, tdeform, rng)
    loose = (loose[0][::3], loose[1][::3])        # one yaw per time
    pipe = PipelineParams()
    jargs = (jpool, jdeform, hp, pipe, jnp.asarray(BG), jnp.asarray(AABB), 3,
             "fine", J_CFG)
    targs = (tpool, tdeform, pipe, torch.from_numpy(BG),
             torch.from_numpy(AABB), 3, "fine", T_CFG)
    root = tmp_path_factory.mktemp("eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LPIPS_WEIGHTS", LPIPS_FIXTURE)
        lpips_jax._load_weights.cache_clear()
        j_video._jit_render.cache_clear()
        j_video._jit_render_mc.cache_clear()
        calls = {"multicam": 0, "render": 0}

        def count(name, fn):
            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

        mp.setattr(t_video, "render_multicam",
                   count("multicam", t_video.render_multicam))
        mp.setattr(t_video, "render", count("render", t_video.render))
        out = {}
        for name, (jc, tc) in (("grouped", grouped), ("loose", loose)):
            before = dict(calls)
            # the grouped split also writes the dynamic/static PLYs
            pcd = dict(save_separate_pcd=name == "grouped")
            out[name] = (
                j_video.render_pixels(jc, *jargs,
                                      pcd_dir=str(root / "jax_pcd"), **pcd),
                t_video.render_pixels(tc, *targs,
                                      pcd_dir=str(root / "port_pcd"), **pcd),
                {k: calls[k] - before[k] for k in calls})
        jdir, tdir = str(root / "jax"), str(root / "port")
        jres = j_video.do_evaluation(grouped[0], loose[0], [], jpool, jdeform,
                                     hp, pipe, jnp.asarray(BG),
                                     jnp.asarray(AABB), 3, "fine", J_CFG,
                                     jdir, step=7)
        mp.setitem(sys.modules, "imageio", None)      # the PNG fallback
        tres = t_video.do_evaluation(grouped[1], loose[1], [], tpool,
                                     tdeform, pipe, torch.from_numpy(BG),
                                     torch.from_numpy(AABB), 3, "fine", T_CFG,
                                     tdir, step=7)
        unwritten = t_video.do_evaluation(
            [], loose[1], [], tpool, tdeform, pipe, torch.from_numpy(BG),
            torch.from_numpy(AABB), 3, "fine", T_CFG, str(root / "none"),
            step=7, write=False)
    lpips_jax._load_weights.cache_clear()
    j_video._jit_render.cache_clear()
    j_video._jit_render_mc.cache_clear()
    return Side(out=out, jdir=jdir, tdir=tdir, jres=jres, tres=tres,
                root=root, unwritten=unwritten)


@pytest.mark.parametrize("split", ["grouped", "loose"])
def test_render_pixels_takes_the_rig_or_camera_branch(sweep, split):
    calls = sweep.out[split][2]
    n = 9 if split == "grouped" else 4
    # grouped: 3 rig renders + 2 flow renders a camera; loose: per camera
    assert calls == ({"multicam": 3, "render": 2 * n} if split == "grouped"
                     else {"multicam": 0, "render": 3 * n})


@pytest.mark.parametrize("split", ["grouped", "loose"])
def test_render_pixels_frames_match_jax(sweep, split):
    want, got, _ = sweep.out[split]
    assert sorted(k for k in got if isinstance(got[k], list)) == \
        sorted(k for k in want if isinstance(want[k], list))
    n = len(want["rgbs"])
    for key in ("rgbs", "dynamic_rgbs", "static_rgbs", "forward_flows",
                "backward_flows"):
        assert len(got[key]) == len(want[key]) == n, key
        for g, w in zip(got[key], want[key]):
            assert g.dtype == np.float32 and g.shape == (H, W, 3)
            d = np.rint((g - w) * 255.0)
            assert np.abs(d).max() <= 1, key
            assert (d != 0).mean() <= 1e-3, key
    for g, w in zip(got["depths"], want["depths"]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-4)
    for g, w in zip(got["gt_rgbs"], want["gt_rgbs"]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("split", ["grouped", "loose"])
def test_render_pixels_metrics_match_jax(sweep, split):
    want, got, _ = sweep.out[split]
    assert got["metrics"].keys() == want["metrics"].keys()
    pv_w, pv_g = want["metrics_per_view"], got["metrics_per_view"]
    assert pv_g.keys() == pv_w.keys()
    for k, tol in (("psnr", 0.01), ("ssim", 1e-3), ("masked_psnr", 0.01),
                   ("masked_ssim", 1e-3), ("lpips", 1e-3)):
        assert len(pv_g[k]) == len(pv_w[k]) > 0, k
        np.testing.assert_allclose(pv_g[k], pv_w[k], rtol=0, atol=tol,
                                   err_msg=k)
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=0, atol=tol, err_msg=k)
    if split == "grouped":            # one camera's mask is empty
        assert len(pv_g["masked_psnr"]) == len(pv_g["psnr"]) - 1
    assert all(isinstance(x, float) for x in pv_g["lpips"])


def test_ply_split_matches_jax(sweep):
    from s3gaussian_tpu_torch.utils.ply import read_ply
    for name in ("dynamic.ply", "static.ply"):
        want = read_ply(str(sweep.root / "jax_pcd" / name))
        got = read_ply(str(sweep.root / "port_pcd" / name))
        assert got.keys() == want.keys() and len(got["x"]) > 0, name
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")


def test_do_evaluation_without_writing(sweep):
    assert sweep.unwritten.keys() == {"test"}
    np.testing.assert_allclose(sweep.unwritten["test"]["psnr"],
                               sweep.tres["test"]["psnr"], rtol=0, atol=0)
    assert not os.path.exists(sweep.root / "none")


def test_do_evaluation_writes_what_jax_writes(sweep):
    assert sweep.tres.keys() == sweep.jres.keys() == {"test", "train"}
    for split in sweep.jres:
        assert sweep.tres[split].keys() == sweep.jres[split].keys()
    jfiles = sorted(os.listdir(sweep.jdir))
    assert sorted(os.listdir(sweep.tdir)) == jfiles == [
        "metrics", "test_set_7", "train_set_7"]

    def jsons(d):
        names = sorted(os.listdir(os.path.join(d, "metrics")))
        out = {}
        for n in names:
            with open(os.path.join(d, "metrics", n)) as f:
                out[n.split("_")[2]] = json.load(f)
        assert all(n.startswith("7_images_") for n in names)
        return out

    jj, tj = jsons(sweep.jdir), jsons(sweep.tdir)
    assert tj.keys() == jj.keys() == {"test", "train"}
    for split in jj:
        assert tj[split].keys() == jj[split].keys()
    for sub in ("test_set_7", "train_set_7"):
        names = sorted(os.listdir(os.path.join(sweep.jdir, sub)))
        assert sorted(os.listdir(os.path.join(sweep.tdir, sub))) == names
        assert names and all(n.endswith(".png") for n in names)
        for n in names:
            with open(os.path.join(sweep.jdir, sub, n), "rb") as f:
                want = decode_png(f.read())
            with open(os.path.join(sweep.tdir, sub, n), "rb") as f:
                got = decode_png(f.read())
            assert got.shape == want.shape, n
            d = got.astype(int) - want.astype(int)
            if n.startswith(("depths", "gt_rgbs")):
                # depth colours follow the depth's percentiles; a value on
                # a colormap bin edge moves a pixel to the next bin
                assert (d != 0).mean() <= 1e-3, n
            else:
                # to8b truncates, so a ±1 step of the frame may move the
                # written value by one
                assert np.abs(d).max() <= 1 and (d != 0).mean() <= 1e-3, n


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.mark.parametrize("stage,decomp,sh_python", [
    ("fine", True, False),
    ("fine", False, True),
    ("coarse", False, False),
])
def test_render_multicam_matches_jax(scene, stage, decomp, sh_python):
    jpool, jdeform, hp, tpool, tdeform = scene
    cams = [_camera_pair(y, 0.4) for y in YAWS]
    pipe = PipelineParams(convert_SHs_python=sh_python)
    # the coarse rig goes through JAX's scanned core (multicam_scan)
    jcfg = (JRasterConfig(**{**vars(J_CFG), "multicam_scan": True})
            if stage == "coarse" else J_CFG)
    want = jax.jit(lambda c, p, d: j_render_multicam(
        c, len(cams), p, d, hp, pipe, jnp.asarray(BG), jnp.asarray(AABB), 3,
        stage=stage, return_decomposition=decomp, cfg=jcfg))(stack_cameras([c[0] for c in cams]), jpool,
                   jdeform if stage == "fine" else None)
    with torch.no_grad():
        got = t_render_multicam(
            [c[1] for c in cams], tpool,
            tdeform if stage == "fine" else None, pipe, torch.from_numpy(BG),
            torch.from_numpy(AABB), 3, stage=stage,
            return_decomposition=decomp, cfg=T_CFG)
    keys = ["render", "depth"] + (["render_d", "depth_d", "render_s",
                                   "depth_s"] if decomp else [])
    for k in keys:
        assert got[k].shape[0] == len(cams), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-4, rtol=1e-4, err_msg=k)
    for k in ("radii", "visibility_filter") + (("dynamic_mask",) if decomp
                                               else ()):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    ja, ta = want["raster_aux"], got["raster_aux"]
    np.testing.assert_array_equal(ta["visible"].numpy(),
                                  np.asarray(ja["visible"]))
    np.testing.assert_array_equal(ta["vis_count"].numpy(),
                                  np.asarray(ja["vis_count"]))
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(ta[k]) == int(ja[k]), k
    assert int(ta["n_pairs"]) > 0
    if stage == "fine":
        np.testing.assert_allclose(got["dx"].numpy(), np.asarray(want["dx"]),
                                   atol=1e-5, rtol=0)
    else:
        assert got["dx"] is None and want["dx"] is None


def test_render_multicam_equals_per_camera_renders(scene):
    """One shared deformation evaluation gives each camera the frame its
    own render() gives."""
    _, _, _, tpool, tdeform = scene
    cams = [_camera_pair(y, 0.7)[1] for y in YAWS]
    args = (tpool, tdeform, PipelineParams(), torch.from_numpy(BG),
            torch.from_numpy(AABB), 3)
    with torch.no_grad():
        rig = t_render_multicam(cams, *args, return_decomposition=True,
                                cfg=T_CFG)
        for b, cam in enumerate(cams):
            one = t_render(cam, *args, return_decomposition=True,
                           cfg=T_CFG)
            for k in ("render", "depth", "render_d", "render_s"):
                torch.testing.assert_close(rig[k][b], one[k], rtol=0,
                                           atol=0, msg=k)


def test_render_multicam_refuses_cull_before_deform(scene):
    """cull_before_deform, once refused here, renders the rig from the
    union cull as JAX's unrolled loop does, with a budget below the
    union so the candidate order decides the working set."""
    jpool, jdeform, hp, tpool, tdeform = scene
    cams = [_camera_pair(y, 0.4) for y in YAWS]
    pipe = PipelineParams()
    kw = dict(cull_before_deform=True, max_visible=192, cull_margin_px=8.0)
    want = jax.jit(lambda c, p, d: j_render_multicam(
        c, len(cams), p, d, hp, pipe, jnp.asarray(BG), jnp.asarray(AABB), 3,
        cfg=JRasterConfig(**{**vars(J_CFG), **kw})))(
            stack_cameras([c[0] for c in cams]), jpool, jdeform)
    with torch.no_grad():
        got = t_render_multicam(
            [c[1] for c in cams], tpool, tdeform, pipe, torch.from_numpy(BG),
            torch.from_numpy(AABB), 3,
            cfg=RasterConfig(**{**vars(T_CFG), **kw}))
    for k in ("render", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))
    np.testing.assert_array_equal(got["alive_work"].numpy(),
                                  np.asarray(want["alive_work"]))
    ja, ta = want["raster_aux"], got["raster_aux"]
    for k in ("visible", "vis_count"):
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(ta[k]) == int(ja[k]), k
    assert got["dx"].shape[0] == 192
