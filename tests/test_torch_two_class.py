"""Port parity of two-class pair emission (``big_budget > 0``): every
render slot emits a 2×2 core, the first ``big_budget`` big Gaussians
their periphery from a second section of the slot stream.

  * ``make_pair_keys`` against JAX's on the SAME projection (the JAX
    outputs handed to the port): keys, ``big_sel``, ``big_granted``,
    ``big_rank`` and the counters bit-equal, for the scenes of
    ``tests/test_two_class.py`` (seeds 0–2, a demotion case with budget
    1, an all-small scene) on 8-px tiles, with and without the visible
    compaction;
  * ``rasterize`` with ``big_budget > 0``: forward at the compositor
    tolerances (rgb/depth atol 5e-4 rtol 1e-4, radii exact), gradients
    of every input at the rasterizer's (atol 2e-5·max|want|, rtol 2e-4);
  * within the port, two-class equals single-class while the budget
    holds (``tests/test_two_class.py``'s tolerances: forward atol 1e-6,
    gradients rtol 1e-5 atol 1e-6), and a demoted big keeps its core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.ops import binning as jbin
from s3gaussian_tpu.ops import project as jproject
from s3gaussian_tpu.ops.rasterizer import RasterSettings as JSettings
from s3gaussian_tpu.ops.rasterizer import rasterize as j_rasterize
from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.ops import binning as tbin
from s3gaussian_tpu_torch.ops.project import ProjectedGaussians
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings as TSettings
from s3gaussian_tpu_torch.ops.rasterizer import rasterize as t_rasterize

from scenes import random_scene
from torch_threads import one_torch_thread  # noqa: F401

W = H = 48
# 8-px tiles (a 6×6 grid): the scenes' larger splats span more than 2×2
# tiles, so they are bigs
TILE, RECT = 8, 8
BG = np.array([0.1, 0.2, 0.3], np.float32)
NAMES = ("means", "scales", "quats", "opacity", "colors")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scene(seed, scale_mul=1.0):
    """test_two_class.py's scene: 60 splats, scales 0.05–0.6."""
    sc = random_scene(n=60, seed=seed, w=W, h=H)
    sc["scales"] = (sc["scales"] * scale_mul).astype(np.float32)
    return sc


# (seed, scale multiplier, big budget, max_visible): seeds 0-2 with the
# budget covering every big; the demotion case (scales x3, budget 1);
# the all-small scene (scales x0.02); a render budget below the pool
CASES = [(0, 1.0, 256, 256), (1, 1.0, 256, 256), (2, 1.0, 256, 256),
         (4, 3.0, 1, 256), (5, 0.02, 64, 256), (1, 1.0, 8, 40)]


@pytest.mark.parametrize("seed,scale_mul,budget,max_visible", CASES)
def test_make_pair_keys_matches_jax(seed, scale_mul, budget, max_visible):
    sc = _scene(seed, scale_mul)
    cov = jproject.build_cov3d(jnp.asarray(sc["scales"]),
                               jnp.asarray(sc["quats"]))
    op = jnp.asarray(sc["opacity"])
    proj = jax.jit(lambda m, c, v, pm, o: jproject.project_gaussians(
        m, c, v, pm, sc["tanfov"], sc["tanfov"], W, H, TILE, TILE,
        opacities=o))(jnp.asarray(sc["means"]), cov, jnp.asarray(sc["view"]),
                      jnp.asarray(sc["proj"]), op)
    tproj = ProjectedGaussians(*[torch.from_numpy(np.array(x)) for x in proj])
    g = -(-W // TILE)
    nb = min(budget, max_visible, 60)
    pk = jax.jit(lambda p, o: jbin.make_pair_keys(
        p, g, g, max_visible, RECT, RECT, TILE, TILE, opacities=o,
        big_budget=nb))(proj, op)
    tpk = tbin.make_pair_keys(tproj, g, g, max_visible, RECT, RECT, TILE,
                              TILE, opacities=torch.from_numpy(np.array(op)),
                              big_budget=nb)
    nr = min(max_visible, 60)
    assert tpk.keys.shape[0] == 4 * nr + (RECT * RECT - 4) * nb
    # the port holds JAX's uint32 key as int32, less 2^31
    np.testing.assert_array_equal(
        tpk.keys.numpy(),
        (np.asarray(pk.keys).astype(np.int64) - tbin.KEY_BIAS).astype(
            np.int32))
    for k in ("sel", "sel_visible", "big_sel", "big_granted", "big_rank"):
        np.testing.assert_array_equal(getattr(tpk, k).numpy(),
                                      np.asarray(getattr(pk, k)), err_msg=k)
    for k in ("n_visible", "overflow_rect", "overflow_visible"):
        assert int(getattr(tpk, k)) == int(getattr(pk, k)), k
    n_big = int(np.asarray(pk.big_granted).sum())
    if scale_mul == 0.02:
        assert n_big == 0                 # the periphery section is empty
    else:
        assert n_big > 0


def _settings(sc, pkg):
    s = (H, W, sc["tanfov"], sc["tanfov"])
    if pkg == "jax":
        return JSettings(*s, jnp.asarray(BG), 1.0, jnp.asarray(sc["view"]),
                         jnp.asarray(sc["proj"]), 0, jnp.zeros(3))
    return TSettings(*s, t(BG), 1.0, t(sc["view"]), t(sc["proj"]), 0,
                     torch.zeros(3))


def _cfgs(budget, max_visible=256):
    kw = dict(tile_x=TILE, tile_y=TILE, max_visible=max_visible,
              rect_w=RECT, rect_h=RECT, big_budget=budget)
    # the jnp compositor scans max_pairs_per_tile pairs a tile; every
    # tile here stays below 512
    return (JRasterConfig(chunk=16, use_pallas=False, max_pairs_per_tile=512,
                          **kw),
            RasterConfig(**kw))


def _args(sc):
    return [sc["means"], sc["scales"], sc["quats"], sc["opacity"],
            sc["colors"]]


def _target():
    return np.random.default_rng(0).random((3, H, W)).astype(np.float32)


def jax_loss(sc, cfg):
    settings, tgt = _settings(sc, "jax"), jnp.asarray(_target())

    def loss(means, scales, quats, opac, colors):
        color, _, depth, _ = j_rasterize(settings, means, opac, scales=scales,
                                         rotations=quats,
                                         colors_precomp=colors, cfg=cfg)
        return jnp.sum((color - tgt) ** 2) + 0.1 * jnp.sum(depth)

    return loss


def torch_run(sc, cfg, grads=True):
    """(loss, grads, color, radii, depth, aux) of the port."""
    settings, tgt = _settings(sc, "torch"), t(_target())
    leaves = [t(a).requires_grad_(grads) for a in _args(sc)]
    means, scales, quats, opac, colors = leaves
    color, radii, depth, aux = t_rasterize(settings, means, opac,
                                           scales=scales, rotations=quats,
                                           colors_precomp=colors, cfg=cfg)
    loss = torch.sum((color - tgt) ** 2) + 0.1 * torch.sum(depth)
    g = torch.autograd.grad(loss, leaves) if grads else None
    return loss, g, color, radii, depth, aux


@pytest.mark.parametrize("seed,scale_mul,budget", [
    (3, 1.0, 256),          # every big granted
    (4, 3.0, 2),            # demotion: most bigs keep their core only
])
def test_two_class_rasterize_matches_jax(seed, scale_mul, budget):
    sc = _scene(seed, scale_mul)
    jcfg, tcfg = _cfgs(budget)
    jargs = [jnp.asarray(a) for a in _args(sc)]
    color, radii, depth, aux = jax.jit(lambda a: j_rasterize(
        _settings(sc, "jax"), a[0], a[3], scales=a[1], rotations=a[2],
        colors_precomp=a[4], cfg=jcfg))(jargs)
    want_v, want = jax.jit(jax.value_and_grad(
        jax_loss(sc, jcfg), argnums=tuple(range(5))))(*jargs)
    got_v, got, tcolor, tradii, tdepth, taux = torch_run(sc, tcfg)
    np.testing.assert_allclose(tcolor.detach().numpy(), np.asarray(color),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(tdepth.detach().numpy(), np.asarray(depth),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(tradii.numpy(), np.asarray(radii))
    for k in ("n_pairs", "overflow_rect", "overflow_visible",
              "overflow_pairs"):
        assert int(taux[k]) == int(aux[k]), k
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-5)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * scale,
                                   rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_class_equals_single_class(seed):
    sc = _scene(seed)
    _, one = _cfgs(0)
    _, two = _cfgs(256)
    v0, g0, c0, r0, d0, a0 = torch_run(sc, one)
    v1, g1, c1, r1, d1, a1 = torch_run(sc, two)
    assert int(a1["n_pairs"]) == int(a0["n_pairs"]) > 0
    assert int(a1["overflow_rect"]) == int(a0["overflow_rect"])
    np.testing.assert_allclose(c1.detach().numpy(), c0.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(d1.detach().numpy(), d0.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(r1.numpy(), r0.numpy())
    np.testing.assert_allclose(v1.item(), v0.item(), rtol=1e-6)
    for name, a, b in zip(NAMES, g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_demoted_bigs_keep_their_core():
    sc = _scene(4, 3.0)
    _, full = _cfgs(256)
    _, one = _cfgs(1)
    *_, c_full, _, _, a_full = torch_run(sc, full, grads=False)
    *_, c, _, _, a = torch_run(sc, one, grads=False)
    assert int(a["overflow_rect"]) > int(a_full["overflow_rect"])
    assert 0 < int(a["n_pairs"]) < int(a_full["n_pairs"])
    assert torch.isfinite(c).all()
