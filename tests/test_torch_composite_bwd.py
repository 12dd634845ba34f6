"""Port parity: the backward compositor.

``composite_tiles_bwd_torch`` (the plain version of
``csrc/composite_bwd.cu``) is held against the JAX jnp oracle
``composite_tiles_bwd_jnp`` on two seeds, a high-opacity scene whose
pixels saturate (the early exit), a 256-pair chunk, and against the
Pallas kernel ``composite_bwd_pallas`` in interpret mode, at the
tolerance of ``tests/test_tile_kernels.py:91-93``: atol 1e-5·max|want|,
rtol 1e-4 over the first ``n_pairs`` columns.  Columns past ``n_pairs``
and rows 10-15 must be exactly 0.  The cotangent has rows 5-7 zero, as
the rasterizer's has.  The CUDA kernel is compared with the plain version
on the card only (test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.ops import composite as jcomp
from s3gaussian_tpu.ops import tile_kernels as jtk
from s3gaussian_tpu_torch.ops import composite as tcomp
from s3gaussian_tpu_torch.ops import tile_kernels as ttk

from test_torch_composite import HIGH_OPACITY, TILE, binned_scene, torch_pair
from torch_threads import one_torch_thread  # noqa: F401


def _cotangent(out, seed):
    dout = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      tuple(out.shape)), np.float32)
    dout[:, 5:] = 0.0
    return dout


def assert_grads_close(got, want, n_pairs):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want[:, :n_pairs]).max(), 1e-6)
    np.testing.assert_allclose(got[:, :n_pairs], want[:, :n_pairs],
                               atol=1e-5 * scale, rtol=1e-4)
    np.testing.assert_array_equal(got[:, n_pairs:], 0.0)
    np.testing.assert_array_equal(got[tcomp.N_DATA_ROWS:], 0.0)


@pytest.mark.parametrize("seed,scene,chunk", [
    (0, {}, 16),
    (1, {}, 128),
    (2, HIGH_OPACITY, 16),            # near-opaque: pixels saturate
    (3, {}, 256),
])
def test_plain_backward_matches_jnp(seed, scene, chunk):
    pair_feat, starts, gx, gy = binned_scene(seed, **scene)
    n_pairs = int(np.asarray(starts)[-1])
    max_chunks = -(-pair_feat.shape[1] // 16)
    out = jcomp.composite_tiles_jnp(pair_feat, starts, gx, gy, TILE, TILE,
                                    16, max_chunks)
    dout = _cotangent(out, seed)
    want = jcomp.composite_tiles_bwd_jnp(pair_feat, starts, out,
                                         jnp.asarray(dout), gx, gy, TILE,
                                         TILE, 16, max_chunks)
    feat_t, starts_t = torch_pair(pair_feat, starts)
    got = tcomp.composite_tiles_bwd_torch(
        feat_t, starts_t, torch.from_numpy(np.array(out)),
        torch.from_numpy(dout), gx, gy, TILE, TILE, chunk)
    assert_grads_close(got, want, n_pairs)
    if scene:
        assert (np.asarray(out)[:, 4] < 1e-2).any()


@pytest.mark.parametrize("seed,scene", [(4, {}), (5, HIGH_OPACITY)])
def test_plain_backward_matches_pallas_interpret(seed, scene):
    pair_feat, starts, gx, gy = binned_scene(seed, w=32, h=32, **scene)
    n_pairs = int(np.asarray(starts)[-1])
    out = jtk.composite_fwd_pallas(pair_feat, starts, gx, gy, TILE, TILE, 128)
    dout = _cotangent(out, seed)
    want = jtk.composite_bwd_pallas(pair_feat, starts, out, jnp.asarray(dout),
                                    gx, gy, TILE, TILE, 128)
    feat_t, starts_t = torch_pair(pair_feat, starts)
    got = tcomp.composite_tiles_bwd_torch(
        feat_t, starts_t, torch.from_numpy(np.array(out)),
        torch.from_numpy(dout), gx, gy, TILE, TILE)
    assert_grads_close(got, want, n_pairs)


def test_backward_wrapper_on_cpu_takes_plain_path():
    pair_feat, starts, gx, gy = binned_scene(1)
    feat_t, starts_t = torch_pair(pair_feat, starts)
    out = ttk.composite_fwd(feat_t, starts_t, gx, gy, TILE, TILE)
    dout = torch.from_numpy(_cotangent(out, 1))
    before = ttk.launches["composite_bwd"]
    got = ttk.composite_bwd(feat_t, starts_t, out, dout, gx, gy, TILE, TILE)
    assert ttk.launches["composite_bwd"] == before    # no kernel ran
    torch.testing.assert_close(
        got, tcomp.composite_tiles_bwd_torch(feat_t, starts_t, out, dout, gx,
                                             gy, TILE, TILE), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ttk.composite_bwd(feat_t, starts_t, out[:-1], dout, gx, gy, TILE,
                          TILE)
    with pytest.raises(ValueError):
        ttk.composite_bwd(feat_t, starts_t, out, dout[:, :5], gx, gy, TILE,
                          TILE)
    with pytest.raises(ValueError):
        ttk.composite_bwd(feat_t.to("meta"), starts_t.to("meta"),
                          out.to("meta"), dout.to("meta"), gx, gy, TILE, TILE)


def test_composite_tiles_function_gradient():
    """Autograd through ``CompositeTiles`` gives the plain backward's
    per-pair gradients, and rows 5-7 of the output carry none."""
    pair_feat, starts, gx, gy = binned_scene(0)
    feat_t, starts_t = torch_pair(pair_feat, starts)
    feat_t.requires_grad_(True)
    out = ttk.CompositeTiles.apply(feat_t, starts_t, gx, gy, TILE, TILE)
    dout = torch.from_numpy(_cotangent(out.detach(), 7))
    dout_all = dout.clone()
    dout_all[:, 5:] = 3.0          # ignored: not differentiable
    (out * dout_all).sum().backward()
    want = tcomp.composite_tiles_bwd_torch(feat_t.detach(), starts_t,
                                           out.detach(), dout, gx, gy, TILE,
                                           TILE)
    torch.testing.assert_close(feat_t.grad, want, rtol=0, atol=0)
