"""Port parity: the forward compositor.

The plain PyTorch compositor is held against the JAX jnp oracle
(``composite_tiles_jnp``) on two seeds and a high-opacity scene that
saturates tiles, and on one tiny case against the Pallas kernel in
interpret mode, at the tolerances of ``tests/test_tile_kernels.py``:
rgb/depth atol 5e-4 rtol 1e-4, final_T atol 2e-4, n_contrib within 1.
Every tile stays under the jnp oracle's ``max_pairs_per_tile`` cap (the
oracle truncates there; the Pallas kernel and the port do not).  The
CUDA kernel itself is compared with the plain version on the card only
(test_torch_cuda.py, which imports no jax so that it runs there).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.ops import composite as jcomp
from s3gaussian_tpu.ops import tile_kernels as jtk
from s3gaussian_tpu.ops.binning import bin_gaussians
from s3gaussian_tpu.ops.project import build_cov3d, project_gaussians
from s3gaussian_tpu_torch.ops import composite as tcomp
from s3gaussian_tpu_torch.ops import tile_kernels as ttk

from scenes import random_scene
from torch_threads import one_torch_thread  # noqa: F401

TILE = 16


def binned_scene(seed=0, n=70, w=64, h=64, opacity_range=(0.2, 0.95),
                 scale_range=(0.02, 0.12)):
    """The recipe of test_tile_kernels.binned_scene: a depth-sorted
    [16, M] pair stream and tile starts, built by the JAX package."""
    gx, gy = -(-w // TILE), -(-h // TILE)
    sc = random_scene(n=n, seed=seed, w=w, h=h, opacity_range=opacity_range,
                      scale_range=scale_range)
    cov = build_cov3d(jnp.asarray(sc["scales"]), jnp.asarray(sc["quats"]))
    proj = project_gaussians(jnp.asarray(sc["means"]), cov,
                             jnp.asarray(sc["view"]), jnp.asarray(sc["proj"]),
                             sc["tanfov"], sc["tanfov"], w, h, TILE, TILE)
    b = bin_gaussians(proj, gx, gy, max_visible=128, rect_w=8, rect_h=8,
                      tile_x=TILE, tile_y=TILE)
    feat_pool = jcomp.pack_pool_features(proj.xy, proj.conic,
                                         jnp.asarray(sc["opacity"]),
                                         jnp.asarray(sc["colors"]), proj.depth)
    pair_feat = feat_pool[:, b.sel[b.sorted_gid]]
    return pair_feat, b.tile_starts, gx, gy


def assert_tiles_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0:4], want[:, 0:4], atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=2e-4)
    np.testing.assert_allclose(got[:, 5], want[:, 5], atol=1.0)
    np.testing.assert_array_equal(got[:, 6:], 0.0)


def torch_pair(pair_feat, tile_starts):
    return (torch.from_numpy(np.array(pair_feat)),
            torch.from_numpy(np.array(tile_starts)))


HIGH_OPACITY = dict(n=120, opacity_range=(0.9, 0.99),
                    scale_range=(0.1, 0.4))


@pytest.mark.parametrize("seed,scene,chunk", [
    (0, {}, 16),
    (1, {}, 128),
    (2, HIGH_OPACITY, 16),            # near-opaque: pixels saturate
])
def test_plain_compositor_matches_jnp(seed, scene, chunk):
    pair_feat, starts, gx, gy = binned_scene(seed, **scene)
    counts = np.diff(np.asarray(starts))
    max_chunks = -(-pair_feat.shape[1] // 16)
    assert counts.max() <= max_chunks * 16       # under the oracle's cap
    want = jcomp.composite_tiles_jnp(pair_feat, starts, gx, gy, TILE, TILE,
                                     16, max_chunks)
    got = tcomp.composite_tiles_torch(*torch_pair(pair_feat, starts), gx, gy,
                                      TILE, TILE, chunk)
    assert_tiles_close(got, want)
    if scene:
        # saturated pixels: T fell to ~1e-4 and later pairs were cut
        assert (np.asarray(want)[:, 4] < 1e-2).any()


def test_plain_compositor_matches_pallas_interpret():
    pair_feat, starts, gx, gy = binned_scene(4, n=30, w=32, h=32)
    want = jtk.composite_fwd_pallas(pair_feat, starts, gx, gy, TILE, TILE,
                                    128)
    got = tcomp.composite_tiles_torch(*torch_pair(pair_feat, starts), gx, gy,
                                      TILE, TILE)
    assert_tiles_close(got, want)


def test_wrapper_on_cpu_takes_plain_path():
    pair_feat, starts, gx, gy = binned_scene(1)
    feat_t, starts_t = torch_pair(pair_feat, starts)
    before = ttk.launches["composite_fwd"]
    got = ttk.composite_fwd(feat_t, starts_t, gx, gy, TILE, TILE)
    assert ttk.launches["composite_fwd"] == before    # no kernel ran
    torch.testing.assert_close(
        got, tcomp.composite_tiles_torch(feat_t, starts_t, gx, gy, TILE, TILE),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        ttk.composite_fwd(feat_t[:10], starts_t, gx, gy, TILE, TILE)
    with pytest.raises(ValueError):
        ttk.composite_fwd(feat_t, starts_t[:-1], gx, gy, TILE, TILE)
    with pytest.raises(ValueError):
        ttk.composite_fwd(feat_t.to("meta"), starts_t.to("meta"), gx, gy,
                          TILE, TILE)


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(0)
    n = 40
    xy, conic = rng.random((n, 2)), rng.random((n, 3))
    op, col, depth = rng.random(n), rng.random((n, 3)), rng.random(n)
    args = [a.astype(np.float32) for a in (xy, conic, op, col, depth)]
    np.testing.assert_array_equal(
        tcomp.pack_pool_features(*[torch.from_numpy(a) for a in args]).numpy(),
        np.asarray(jcomp.pack_pool_features(*[jnp.asarray(a) for a in args])))
    out = rng.random((3 * 2, 8, 16 * 16)).astype(np.float32)
    want = jcomp.unpack_tiles(jnp.asarray(out), 30, 40, 3, 2, 16, 16)
    got = tcomp.unpack_tiles(torch.from_numpy(out), 30, 40, 3, 2, 16, 16)
    for k in ("rgb", "depth", "final_T", "n_contrib"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

