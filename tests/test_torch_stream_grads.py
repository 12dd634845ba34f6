"""Port parity of the pair stream's backward (``ops/rasterizer.py::
SortStreamGather``) against the JAX package's custom VJP
(``composite_core``, ``use_custom_vjp=True``, no bfloat16 packing), run as
``tests/test_rasterize_grads.py`` runs it: the jnp compositor and its
hand-written VJP on the CPU.  The port's backward zeroes the pairs past
``n_pairs``, un-sorts by emission slot, sums the rect axis (the two
sections' strides with two-class emission, the granted bigs' peripheries
at ``big_rank``) and expands back to the pool by rank, as JAX's does.

Cases: single-class; two-class with granted bigs; a render budget below
the pool (``nr < N``, single- and two-class); a pair budget below the
emitted slots (``bp < m``).  Tolerance: the rasterizer's input gradients,
atol 2e-5·max|want| rtol 2e-4 (``test_rasterize_grads.py:62-65``).
Then, without JAX: the backward against autograd of the gather it
replaces (``data[:, gid]``), and two backward passes bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.ops.rasterizer import RasterSettings as JSettings
from s3gaussian_tpu.ops.rasterizer import rasterize as j_rasterize
from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.ops import binning as tbin
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings as TSettings
from s3gaussian_tpu_torch.ops.rasterizer import (SortStreamGather, pair_keys,
                                                 project_and_pack)
from s3gaussian_tpu_torch.ops.rasterizer import rasterize as t_rasterize

from scenes import random_scene
from torch_threads import one_torch_thread  # noqa: F401

W = H = 48
# 8-px tiles: the scenes' larger splats span more than 2×2 tiles (bigs)
TILE, RECT = 8, 8
N = 60
BG = np.array([0.1, 0.2, 0.3], np.float32)
NAMES = ("means", "scales", "quats", "opacity", "colors")

# (big_budget, max_visible, pair_budget)
CASES = {
    "single_class": (0, 256, 1 << 16),
    "two_class": (256, 256, 1 << 16),
    "render_budget_below_pool": (0, 40, 1 << 16),
    "two_class_render_budget_below_pool": (8, 40, 1 << 16),
    "pair_budget_below_slots": (0, 256, 1536),
}


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cfgs(budget, max_visible, pair_budget):
    kw = dict(tile_x=TILE, tile_y=TILE, max_visible=max_visible,
              rect_w=RECT, rect_h=RECT, big_budget=budget,
              pair_budget=pair_budget)
    # the jnp compositor scans max_pairs_per_tile pairs a tile; every tile
    # here stays below 512
    return (JRasterConfig(chunk=16, use_pallas=False, max_pairs_per_tile=512,
                          sort_bf16=False, **kw),
            RasterConfig(**kw))


def _args(sc):
    return [sc["means"], sc["scales"], sc["quats"], sc["opacity"],
            sc["colors"]]


def _target():
    rng = np.random.default_rng(0)
    return (rng.random((3, H, W)).astype(np.float32),
            rng.uniform(1, 5, (H, W)).astype(np.float32))


def _settings(sc, pkg):
    s = (H, W, sc["tanfov"], sc["tanfov"])
    if pkg == "jax":
        return JSettings(*s, jnp.asarray(BG), 1.0, jnp.asarray(sc["view"]),
                         jnp.asarray(sc["proj"]), 0, jnp.zeros(3))
    return TSettings(*s, t(BG), 1.0, t(sc["view"]), t(sc["proj"]), 0,
                     torch.zeros(3))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_backward_matches_jax_custom_vjp(case):
    budget, max_visible, pair_budget = CASES[case]
    sc = random_scene(n=N, seed=3, w=W, h=H)
    jcfg, tcfg = _cfgs(budget, max_visible, pair_budget)
    tgt_c, tgt_d = _target()
    settings = _settings(sc, "jax")

    def jloss(means, scales, quats, opac, colors):
        color, _, depth, _ = j_rasterize(settings, means, opac,
                                         scales=scales, rotations=quats,
                                         colors_precomp=colors, cfg=jcfg,
                                         use_custom_vjp=True)
        return (jnp.mean(jnp.abs(color - tgt_c))
                + 0.3 * jnp.mean((depth - tgt_d) ** 2))

    want_v, want = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5))))(*[jnp.asarray(a) for a in _args(sc)])

    leaves = [t(a).requires_grad_(True) for a in _args(sc)]
    means, scales, quats, opac, colors = leaves
    color, _, depth, aux = t_rasterize(_settings(sc, "torch"), means, opac,
                                       scales=scales, rotations=quats,
                                       colors_precomp=colors, cfg=tcfg)
    loss = (torch.mean(torch.abs(color - t(tgt_c)))
            + 0.3 * torch.mean((depth - t(tgt_d)) ** 2))
    got = torch.autograd.grad(loss, leaves)

    # the case holds what it names
    nr = min(max_visible, N)
    m = (4 * nr + (RECT * RECT - 4) * min(budget, nr) if budget
         else nr * RECT * RECT)
    assert int(aux["n_pairs"]) > 0 and int(aux["overflow_pairs"]) == 0
    assert (nr < N) == case.endswith("below_pool")
    assert (pair_budget < m) == (case == "pair_budget_below_slots")
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * scale,
                                   rtol=2e-4, err_msg=name)


def _stream_inputs(budget, max_visible, pair_budget):
    """The pair keys and feature rows of the scene, and what
    ``bin_pairs`` hands ``SortStreamGather``."""
    sc = random_scene(n=N, seed=4, w=W, h=H)
    _, cfg = _cfgs(budget, max_visible, pair_budget)
    leaves = [t(a) for a in _args(sc)]
    settings = _settings(sc, "torch")
    proj, feat = project_and_pack(settings, leaves[0], leaves[3], leaves[1],
                                  leaves[2], colors_precomp=leaves[4],
                                  cfg=cfg)
    pk = pair_keys(settings, proj, leaves[3], cfg)
    m = pk.keys.shape[0]
    bp = min(m, pair_budget)
    sorted_tile, sorted_slot = tbin.sort_pairs(pk)
    _, n_pairs, _ = tbin.tile_ranges(sorted_tile, (W // TILE) ** 2, bp)
    return pk, feat[:10].detach(), sorted_slot[:bp], n_pairs, m


@pytest.mark.parametrize("case", list(CASES))
def test_stream_backward_equals_the_gather_it_replaces(case):
    """Autograd of ``data[:, gid]`` (the scatter) sums the same per-pair
    gradients: equal to float32 rounding, past-``n_pairs`` pairs excluded;
    and two backward passes give the same bits."""
    budget, max_visible, pair_budget = CASES[case]
    pk, rows, slots, n_pairs, m = _stream_inputs(budget, max_visible,
                                                 pair_budget)
    bp = slots.shape[0]
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(10, bp)).astype(np.float32))
    outs = []
    for _ in range(2):
        x = rows.clone().requires_grad_(True)
        y = SortStreamGather.apply(x, slots, n_pairs, pk, RECT * RECT, m)
        outs.append(torch.autograd.grad(y, x, g)[0])
    assert torch.equal(outs[0], outs[1])

    # the same gather under plain autograd, pairs past n_pairs zeroed
    x = rows.double().requires_grad_(True)
    nr = pk.sel.shape[0]
    data = x if nr >= N else x[:, pk.sel]
    if pk.big_sel is None:
        gid = slots // (RECT * RECT)
    else:
        data = torch.cat([data, x[:, pk.big_sel]], 1)
        gid = torch.where(slots < 4 * nr, slots // 4,
                          nr + (slots - 4 * nr) // (RECT * RECT - 4))
    live = (torch.arange(bp) < n_pairs)[None, :]
    want = torch.autograd.grad(data[:, gid], x,
                               torch.where(live, g, 0.0).double())[0]
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(),
                               atol=1e-6 * scale, rtol=1e-6)
