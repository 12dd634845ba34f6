"""Port parity: pair keys, the stable pair sort and tile ranges.

Both packages bin the SAME projection (the JAX outputs, handed to the
port as tensors), so keys, sorted slots and tile starts must be
bit-equal: single-key layout with and without the visible compaction,
and the two-key layout (>= 4,095 tiles)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.ops import binning as jbin
from s3gaussian_tpu.ops import project as jproject
from s3gaussian_tpu_torch.ops import binning as tbin
from s3gaussian_tpu_torch.ops.project import ProjectedGaussians

from scenes import random_scene
from torch_threads import one_torch_thread  # noqa: F401


def _projected(n, seed, w, h, tile):
    sc = random_scene(n=n, seed=seed, w=w, h=h, scale_range=(0.02, 0.3))
    cov = jproject.build_cov3d(jnp.asarray(sc["scales"]),
                               jnp.asarray(sc["quats"]))
    op = jnp.asarray(sc["opacity"])
    proj = jproject.project_gaussians(
        jnp.asarray(sc["means"]), cov, jnp.asarray(sc["view"]),
        jnp.asarray(sc["proj"]), sc["tanfov"], sc["tanfov"], w, h, tile,
        tile, opacities=op)
    tproj = ProjectedGaussians(*[torch.from_numpy(np.array(x)) for x in proj])
    return proj, tproj, op, torch.from_numpy(np.array(op))


@pytest.mark.parametrize("n,max_visible,w,h,tile,rect", [
    (250, 512, 96, 64, 16, 4),     # single key, render set covers the pool
    (250, 120, 96, 64, 16, 4),     # single key, visible compaction
    (200, 256, 256, 256, 4, 8),    # two-key: 64x64 = 4,096 tiles
])
def test_pair_keys_sort_ranges_bit_equal(n, max_visible, w, h, tile, rect):
    gx, gy = -(-w // tile), -(-h // tile)
    proj, tproj, op, top = _projected(n, 0, w, h, tile)
    pk = jbin.make_pair_keys(proj, gx, gy, max_visible, rect, rect, tile,
                             tile, opacities=op)
    tpk = tbin.make_pair_keys(tproj, gx, gy, max_visible, rect, rect, tile,
                              tile, opacities=top)
    assert tpk.two_key == pk.two_key == (gx * gy >= 4095)

    if pk.two_key:
        tile_j = np.asarray(pk.tile_u32).astype(np.int64)
        tile_j[tile_j == 0xFFFFFFFF] = tbin.INVALID_TILE_TWO_KEY
        want_keys = (tile_j << 32) | np.asarray(pk.depth_u32).astype(np.int64)
    else:
        want_keys = np.asarray(pk.keys).astype(np.int64)
    np.testing.assert_array_equal(tpk.keys.numpy(), want_keys)
    np.testing.assert_array_equal(tpk.sel.numpy(), np.asarray(pk.sel))
    np.testing.assert_array_equal(tpk.sel_visible.numpy(),
                                  np.asarray(pk.sel_visible))
    for k in ("n_visible", "overflow_rect", "overflow_visible"):
        assert int(getattr(tpk, k)) == int(getattr(pk, k)), k

    m = want_keys.shape[0]
    slot = jnp.arange(m, dtype=jnp.int32)
    sorted_tile, (sorted_slot,) = jbin.sort_pairs(pk, (slot,))
    t_tile, t_slot = tbin.sort_pairs(tpk)
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(sorted_slot))

    bp = m // 2                      # exercise the budget truncation too
    for budget in (m, bp):
        starts, n_pairs, ovf = jbin.tile_ranges(sorted_tile, gx * gy, budget)
        t_starts, t_n, t_ovf = tbin.tile_ranges(t_tile, gx * gy, budget)
        assert t_starts.dtype == torch.int32
        np.testing.assert_array_equal(t_starts.numpy(), np.asarray(starts))
        assert int(t_n) == int(n_pairs) and int(t_ovf) == int(ovf)
    assert int(n_pairs) > 0


def test_depth_key_bits_match_jax():
    d = np.random.default_rng(0).uniform(0.2, 80.0, 500).astype(np.float32)
    np.testing.assert_array_equal(
        tbin.depth_key_bits(torch.from_numpy(d)).numpy(),
        np.asarray(jbin.depth_key_bits(jnp.asarray(d))).astype(np.int64))


def test_two_class_emission_raises():
    """Two-class emission (big_budget > 0), once refused here, emits
    JAX's pairs in the two-key layout (>= 4,095 tiles) too: the tile and
    full depth bits of each slot, the granted bigs and their ranks."""
    gx = gy = 64
    proj, tproj, op, top = _projected(200, 0, 256, 256, 4)
    pk = jbin.make_pair_keys(proj, gx, gy, 256, 8, 8, 4, 4, opacities=op,
                             big_budget=32)
    tpk = tbin.make_pair_keys(tproj, gx, gy, 256, 8, 8, 4, 4,
                              opacities=top, big_budget=32)
    assert tpk.two_key and pk.two_key
    tile_j = np.asarray(pk.tile_u32).astype(np.int64)
    tile_j[tile_j == 0xFFFFFFFF] = tbin.INVALID_TILE_TWO_KEY
    want = (tile_j << 32) | np.asarray(pk.depth_u32).astype(np.int64)
    np.testing.assert_array_equal(tpk.keys.numpy(), want)
    for k in ("big_sel", "big_granted", "big_rank"):
        np.testing.assert_array_equal(getattr(tpk, k).numpy(),
                                      np.asarray(getattr(pk, k)), err_msg=k)
    assert int(tpk.overflow_rect) == int(pk.overflow_rect)
    assert int(np.asarray(pk.big_granted).sum()) > 0


# (n, max_visible, w, h, tile, rect, big_budget, tight_rect)
REUSE_CASES = {
    "single_class": (250, 512, 96, 64, 16, 4, 0, True),
    "compaction": (250, 120, 96, 64, 16, 4, 0, True),
    "loose_rect": (250, 512, 96, 64, 16, 4, 0, False),
    "two_class": (200, 256, 96, 64, 8, 8, 32, True),
    "two_key_two_class": (200, 256, 256, 256, 4, 8, 32, False),
}


@pytest.mark.parametrize("case", list(REUSE_CASES))
def test_feature_pass_projection_bins_as_the_rgb_pass(case):
    """The feature pass projects the RGB pass's means detached, with no
    screen tap and with other colours: its pair keys, sorted slots and
    tile ranges are the RGB pass's bit for bit, which is what lets it
    take that pass's ``Binning``."""
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.ops import rasterizer as trz

    n, max_visible, w, h, tile, rect, big, tight = REUSE_CASES[case]
    sc = random_scene(n=n, seed=1, w=w, h=h, scale_range=(0.02, 0.3))

    def t(k):
        return torch.from_numpy(sc[k])

    settings = trz.RasterSettings(h, w, sc["tanfov"], sc["tanfov"],
                                  torch.zeros(3), 1.0, t("view"), t("proj"),
                                  0, torch.zeros(3))
    cfg = RasterConfig(max_visible=max_visible, tile_x=tile, tile_y=tile,
                       rect_w=rect, rect_h=rect, big_budget=big,
                       tight_rect=tight, pair_budget=1 << 20)
    means = t("means").requires_grad_(True)
    common = dict(scales=t("scales"), rotations=t("quats"),
                  alive=torch.arange(n) % 7 != 3, cfg=cfg)
    rgb = trz.pair_keys(settings, trz.project_and_pack(
        settings, means, t("opacity"), colors_precomp=t("colors"),
        mean2d_tap=torch.zeros(n, 2, requires_grad=True), **common)[0],
        t("opacity"), cfg)
    feat = trz.pair_keys(settings, trz.project_and_pack(
        settings, means.detach(), t("opacity"),
        colors_precomp=torch.rand(n, 3, generator=torch.Generator()
                                  .manual_seed(2)), **common)[0],
        t("opacity"), cfg)
    assert (rgb.big_sel is not None) == (big > 0)
    for name, a, b in zip(tbin.PairKeys._fields, rgb, feat):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name
    gx, gy = trz.grid_dims(settings, cfg)
    got = [trz.bin_pairs(pk, gx * gy, cfg.pair_budget) for pk in (rgb, feat)]
    assert got[0].pk.keys is None and got[0].n_slots == rgb.keys.shape[0]
    assert int(got[0].n_pairs) > 0
    for name in ("slots", "tile_starts", "n_pairs", "overflow_pairs"):
        assert torch.equal(getattr(got[0], name), getattr(got[1], name)), \
            name


@pytest.mark.parametrize("rig", [False, True])
def test_decomposition_passes_bin_their_own(rig, monkeypatch):
    """With the feature pass and the decomposition on, only the feature
    pass takes a binning, its own camera's RGB pass's; the dynamic and
    static passes, whose alive masks differ, bin their own."""
    from s3gaussian_tpu_torch.render import renderer
    from test_torch_cuda import _graph_cameras, _graph_setup

    cpu = torch.device("cpu")
    state, (sh, _, _, pipe, cfg, _, bg) = _graph_setup(cpu)
    cams = _graph_cameras(cpu, 3 if rig else 1)
    calls = []
    real = renderer.rasterize

    def spy(*a, binning=None, **kw):
        out = real(*a, binning=binning, **kw)
        calls.append((binning, out[3]["binning"]))
        return out

    monkeypatch.setattr(renderer, "rasterize", spy)
    with torch.no_grad():
        if rig:
            pkg = renderer.render_multicam(
                cams, state.pool, state.deform, pipe, bg, state.aabb, sh,
                return_decomposition=True, render_feat=True, cfg=cfg)
        else:
            pkg = renderer.render(
                cams[0], state.pool, state.deform, pipe, bg, state.aabb, sh,
                return_decomposition=True, render_feat=True, cfg=cfg)
    assert "feat" in pkg and "render_d" in pkg and "render_s" in pkg
    b = len(cams)
    assert len(calls) == 4 * b
    # per camera its RGB pass then its feature pass, then per camera the
    # dynamic and the static pass
    for i in range(b):
        (rgb_in, rgb_out), (feat_in, feat_out) = calls[2 * i:2 * i + 2]
        assert rgb_in is None
        assert feat_in is rgb_out and feat_out is rgb_out
    assert all(given is None for given, _ in calls[2 * b:])
    assert len({id(out) for _, out in calls}) == 3 * b
