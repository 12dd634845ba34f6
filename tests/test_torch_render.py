"""Port parity for the whole slice: ``render`` of the JAX package (jnp
compositor on the CPU) vs ``s3gaussian_tpu_torch.render.renderer.render``
(plain compositor on CPU tensors), from one pool built by the JAX
``create_from_pcd`` and one deformation field initialised by JAX and
carried across with ``weights``.

Tolerances: images and depth atol 5e-4, rtol 1e-4 (the compositor
tolerances of ``tests/test_tile_kernels.py``); radii and visibility
exact; dx/dshs atol 1e-5.  The hexplane runs in float32 here
(``grid_compute_bf16=False``): the bfloat16 planes are held to their own
tolerance in test_torch_deformation.py.  Every tile stays far below the
jnp oracle's max_pairs_per_tile cap."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.config import (ModelHiddenParams, PipelineParams,
                                   RasterConfig)
from s3gaussian_tpu.data.cameras import make_camera as j_make_camera
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.models.pool import create_from_pcd as j_create_from_pcd
from s3gaussian_tpu.render.renderer import render as j_render
from s3gaussian_tpu_torch.data.cameras import make_camera as t_make_camera
from s3gaussian_tpu_torch.eval.video import render_pixels
from s3gaussian_tpu_torch.models.pool import create_from_pcd as t_create_from_pcd
from s3gaussian_tpu_torch.render.renderer import render as t_render
from s3gaussian_tpu_torch.weights import (POOL_FIELDS, deformation_from_numpy,
                                          pool_from_numpy)
from torch_threads import one_torch_thread  # noqa: F401

H, W = 64, 96
N, CAP = 260, 288
HP = dict(net_width=16, multires=[1, 2], grid_compute_bf16=False,
          kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                          "output_coordinate_dim": 8,
                          "resolution": [8, 8, 8, 5]})
AABB = np.array([[6.0, 6.0, 9.0], [-6.0, -6.0, 0.0]], np.float32)
CFG = RasterConfig(max_visible=CAP, pair_budget=1 << 16)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    tan = np.tan(0.5)
    z = rng.uniform(1.5, 8.0, N)
    pts = np.stack([rng.uniform(-0.9, 0.9, N) * tan * z,
                    rng.uniform(-0.9, 0.9, N) * tan * z, z], 1)
    pts = pts.astype(np.float32)
    cols = rng.random((N, 3)).astype(np.float32)
    jpool = j_create_from_pcd(pts, cols, CAP)
    # non-trivial higher SH bands and opacities, alive mask with holes
    jpool.features_rest = jnp.asarray(
        0.2 * rng.normal(size=jpool.features_rest.shape), jnp.float32)
    jpool.opacity = jnp.asarray(rng.normal(0.5, 1.0, (CAP, 1)), jnp.float32)
    jpool.alive = jpool.alive & jnp.asarray(rng.random(CAP) > 0.05)
    hp = ModelHiddenParams(**HP)
    deform = init_deformation(jax.random.PRNGKey(seed), hp)
    tpool = pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, jpool)),
                            device="cpu")
    tdeform = deformation_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            deform), hp,
                                     device="cpu")
    return jpool, deform, hp, tpool, tdeform


def _cameras(yaw_deg, time):
    yaw = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])      # c2w rotation
    T = np.array([0.2, -0.1, 0.3])
    return (j_make_camera(R, T, 1.0, 0.8, W, H, time=time),
            t_make_camera(R, T, 1.0, 0.8, W, H, time=time, device="cpu"))


def _close(got, want, atol=5e-4, rtol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.fixture(scope="module")
def scene():
    return _scene(0)


def test_make_camera_matches_jax():
    jc, tc = _cameras(20.0, 0.3)
    for k in ("world_view", "full_proj", "campos"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))
    np.testing.assert_allclose(tc.tanfovx, float(jc.tanfovx), rtol=1e-6)
    assert float(tc.time) == float(jc.time)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    jp = j_create_from_pcd(pts, cols, 512)
    tp = t_create_from_pcd(pts, cols, 512, device="cpu")
    for k in POOL_FIELDS:
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


@pytest.mark.parametrize("yaw,time", [(0.0, 0.4), (15.0, 0.9)])
def test_fine_render_matches_jax(scene, yaw, time):
    jpool, deform, hp, tpool, tdeform = scene
    jc, tc = _cameras(yaw, time)
    pipe = PipelineParams()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = j_render(jc, jpool, deform, hp, pipe, jnp.asarray(bg),
                    jnp.asarray(AABB), 3, stage="fine", cfg=CFG,
                    return_decomposition=True, return_dx=True)
    got = t_render(tc, tpool, tdeform, pipe, torch.from_numpy(bg),
                   torch.from_numpy(AABB), 3, stage="fine", cfg=CFG,
                   return_decomposition=True)
    for k in ("render", "depth", "render_d", "depth_d", "render_s",
              "depth_s"):
        _close(got[k], want[k], msg=k)
    for k in ("dx", "dshs"):
        _close(got[k], want[k], atol=1e-5, rtol=0, msg=k)
    for k in ("radii", "visibility_filter", "visibility_filter_d",
              "visibility_filter_s", "dynamic_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    ja, ta = want["raster_aux"], got["raster_aux"]
    np.testing.assert_array_equal(ta["visible"].numpy(),
                                  np.asarray(ja["visible"]))
    for k in ("n_visible", "n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(ta[k]) == int(ja[k]), k
    assert int(ta["n_pairs"]) > 0
    assert 0 < int(got["dynamic_mask"].sum()) < int(tpool.alive.sum())


def test_coarse_feat_and_override_match_jax(scene):
    jpool, deform, hp, tpool, tdeform = scene
    jc, tc = _cameras(-10.0, 0.5)
    pipe = PipelineParams()
    bg = np.zeros(3, np.float32)
    jbg, tbg = jnp.asarray(bg), torch.from_numpy(bg)
    want = j_render(jc, jpool, None, hp, pipe, jbg, None, 2, stage="coarse",
                    cfg=CFG)
    got = t_render(tc, tpool, None, pipe, tbg, None, 2, stage="coarse",
                   cfg=CFG)
    _close(got["render"], want["render"], msg="coarse render")
    _close(got["depth"], want["depth"], msg="coarse depth")
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))

    want = j_render(jc, jpool, deform, hp, pipe, jbg, jnp.asarray(AABB), 3,
                    stage="fine", cfg=CFG, render_feat=True)
    got = t_render(tc, tpool, tdeform, pipe, tbg, torch.from_numpy(AABB), 3,
                   stage="fine", cfg=CFG, render_feat=True)
    _close(got["feat"], want["feat"], msg="feat")

    colors = np.random.default_rng(1).random((CAP, 3)).astype(np.float32)
    want = j_render(jc, jpool, deform, hp, pipe, jbg, jnp.asarray(AABB), 3,
                    stage="fine", cfg=CFG,
                    override_color=jnp.asarray(colors))
    got = t_render(tc, tpool, tdeform, pipe, tbg, torch.from_numpy(AABB), 3,
                   stage="fine", cfg=CFG,
                   override_color=torch.from_numpy(colors))
    _close(got["render"], want["render"], msg="override_color")


def test_render_pixels_frames(scene):
    _, _, _, tpool, tdeform = scene
    cams = [_cameras(yaw, 0.5)[1] for yaw in (-20.0, 0.0, 20.0)]
    pipe = PipelineParams()
    bg = torch.zeros(3)
    aabb = torch.from_numpy(AABB)
    # no ground truth on these cameras: frames only
    frames = render_pixels(cams, tpool, tdeform, pipe, bg, aabb, 3, "fine",
                           CFG, compute_metrics=False,
                           return_decomposition=True)
    assert sorted(frames) == ["depths", "dynamic_rgbs", "rgbs", "static_rgbs"]
    for cam, rgb, depth in zip(cams, frames["rgbs"], frames["depths"]):
        with torch.no_grad():
            pkg = t_render(cam, tpool, tdeform, pipe, bg, aabb, 3, cfg=CFG)
        assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
        # frames leave the device as uint8, as the JAX sweep's do
        want = torch.round(torch.clamp(pkg["render"], 0, 1).permute(1, 2, 0)
                           * 255).numpy() / 255
        np.testing.assert_allclose(rgb, want, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(depth, pkg["depth"].numpy())
    plain = render_pixels(cams, tpool, tdeform, pipe, bg, aabb, 3, "fine",
                          CFG, compute_metrics=False,
                          return_decomposition=False)
    assert sorted(plain) == ["depths", "rgbs"]


def test_unported_options_raise(scene):
    """cull_before_deform, once refused here, renders what JAX's culled
    render gives, with a budget below the visible set."""
    jpool, deform, hp, tpool, tdeform = scene
    jc, tc = _cameras(0.0, 0.5)
    kw = dict(cull_before_deform=True, max_visible=160, cull_margin_px=8.0)
    cfg = dataclasses.replace(CFG, **kw)
    want = j_render(jc, jpool, deform, hp, PipelineParams(), jnp.zeros(3),
                    jnp.asarray(AABB), 3, stage="fine", return_dx=True,
                    cfg=cfg)
    with torch.no_grad():
        got = t_render(tc, tpool, tdeform, PipelineParams(), torch.zeros(3),
                       torch.from_numpy(AABB), 3, stage="fine", cfg=cfg)
    for k in ("render", "depth"):
        _close(got[k], want[k], msg=k)
    for k in ("radii", "alive_work"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["raster_aux"]["visible"].numpy(),
                                  np.asarray(want["raster_aux"]["visible"]))
    _close(got["dx"], want["dx"], atol=1e-5, rtol=0, msg="dx")


# RasterConfig changes from test_torch_cuda._graph_setup's (8×8 tiles and
# rects, max_visible 2,048 over 1,500 points, pair budget 2^18)
REUSE = {
    "single_class": {},
    "loose_rect": dict(tight_rect=False),
    "two_class": dict(big_budget=64),
    "culled": dict(cull_before_deform=True, max_visible=1024),
    "pair_budget_cut": dict(pair_budget=2048),
}


@pytest.fixture(scope="module")
def reuse_scene():
    from test_torch_cuda import _graph_cameras, _graph_setup
    cpu = torch.device("cpu")
    state, (sh, _, _, pipe, cfg, _, bg) = _graph_setup(cpu)
    cams = [dataclasses.replace(c, feat_map=torch.from_numpy(
        np.random.default_rng(i).random((c.image_height, c.image_width, 3))
        .astype(np.float32))) for i, c in enumerate(_graph_cameras(cpu, 3))]
    return state, sh, pipe, cfg, bg, cams


def _feat_step(scene, case, rig):
    """A fine render with the feature pass on leaf views of the pool and a
    zero tap, then one backward of a random weighting of its render,
    feat and depth.  Returns (outputs, gradients by leaf, binnings of
    the rasterize calls)."""
    from s3gaussian_tpu_torch.render import renderer
    state, sh, pipe, cfg, bg, cams = scene
    cfg = dataclasses.replace(cfg, **REUSE[case])
    pool = state.pool.with_params({k: v.detach().requires_grad_(True)
                                   for k, v in
                                   state.pool.param_dict().items()})
    tap = torch.zeros(((3,) if rig else ()) + (pool.capacity, 2),
                      requires_grad=True)
    if rig:
        pkg = renderer.render_multicam(cams, pool, state.deform, pipe, bg,
                                       state.aabb, sh, render_feat=True,
                                       mean2d_tap=tap, cfg=cfg)
    else:
        pkg = renderer.render(cams[0], pool, state.deform, pipe, bg,
                              state.aabb, sh, render_feat=True,
                              mean2d_tap=tap, cfg=cfg)
    outs = {k: pkg[k] for k in ("render", "feat", "depth", "radii")}
    g = torch.Generator().manual_seed(5)
    loss = sum((outs[k] * torch.randn(outs[k].shape, generator=g)).sum()
               for k in ("render", "feat", "depth"))
    leaves = {**{"pool." + k: v for k, v in pool.param_dict().items()},
              **{"deform." + k: v
                 for k, v in state.deform.named_parameters()},
              "tap": tap}
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return outs, dict(zip(leaves, grads))


@pytest.mark.parametrize("case", list(REUSE))
@pytest.mark.parametrize("rig", [False, True])
def test_feature_pass_reuses_the_rgb_binning_bit_for_bit(reuse_scene, case,
                                                         rig, monkeypatch):
    """The feature pass on its RGB pass's binning renders and
    differentiates exactly as when every pass bins itself: render, feat,
    depth, radii and the gradient of every pool and field leaf and of the
    tap bit for bit; one binning a camera instead of two."""
    from s3gaussian_tpu_torch.ops import rasterizer as trz
    from s3gaussian_tpu_torch.render import renderer

    made = []
    real_bin, real_rast = trz.bin_pairs, renderer.rasterize

    def counted(*a, **kw):
        made.append(real_bin(*a, **kw))
        return made[-1]

    monkeypatch.setattr(trz, "bin_pairs", counted)
    got = _feat_step(reuse_scene, case, rig)
    shared = list(made)
    made.clear()
    monkeypatch.setattr(renderer, "rasterize",
                        lambda *a, binning=None, **kw: real_rast(*a, **kw))
    want = _feat_step(reuse_scene, case, rig)
    n_cams = 3 if rig else 1
    assert (len(shared), len(made)) == (n_cams, 2 * n_cams)
    if case == "two_class":
        assert all(bool(b.pk.big_granted.any()) for b in shared)
    if case == "pair_budget_cut":
        assert all(int(b.overflow_pairs) > 0 for b in shared)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for k, w in want[1].items():
        assert (got[1][k] is None) == (w is None), k
        assert w is None or torch.equal(got[1][k], w), k
    assert want[1]["pool.opacity"] is not None
