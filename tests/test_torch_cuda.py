"""The CUDA compositors, forward and backward, vs their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so that on a GPU machine without
jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of ``tests/test_tile_kernels.py``: rgb/depth atol
5e-4 rtol 1e-4, final_T atol 2e-4, n_contrib within 1; per-pair
gradients atol 1e-5·max|plain|, rtol 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.composite import (composite_tiles_bwd_torch,
                                                composite_tiles_torch)
from s3gaussian_tpu_torch.ops.rasterizer import (RasterSettings,
                                                 project_and_key, sort_stream)
from s3gaussian_tpu_torch.ops.transforms import projection_matrix

W, H = 96, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA compositor has no CPU mode")
    return torch.device("cuda")


def sorted_stream(dev, seed, n, opacity_range, tile):
    """A depth-sorted [16, M] pair stream built by the port's rasterizer
    stages from a random frustum scene."""
    rng = np.random.default_rng(seed)
    tan = math.tan(0.5)
    z = rng.uniform(1.5, 8.0, n)
    means = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                      rng.uniform(-0.9, 0.9, n) * tan * z, z], 1)
    q = rng.normal(size=(n, 4))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    view = np.eye(4, dtype=np.float32)
    full = view @ projection_matrix(0.01, 100.0, 1.0, 1.0).T
    settings = RasterSettings(H, W, tan, tan, t(np.zeros(3)), 1.0, t(view),
                              t(full), 0, t(np.zeros(3)))
    cfg = RasterConfig(tile_x=tile, tile_y=tile, max_visible=n, rect_w=8,
                       rect_h=8, pair_budget=1 << 20)
    _, pk, feat = project_and_key(
        settings, t(means), t(rng.uniform(*opacity_range, n)),
        scales=t(rng.uniform(0.02, 0.3, (n, 3))),
        rotations=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
        colors_precomp=t(rng.random((n, 3))), cfg=cfg)
    gx, gy = -(-W // tile), -(-H // tile)
    stream, starts, n_pairs, _ = sort_stream(feat, pk, gx * gy, cfg.rect_cap,
                                             cfg.pair_budget)
    assert int(n_pairs) > 0
    return stream, starts, gx, gy


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,opacity_range,tile", [
    (0, 150, (0.2, 0.95), 16),
    (1, 300, (0.9, 0.99), 16),      # near-opaque: the whole-tile early exit
    (2, 150, (0.2, 0.95), 8),       # 64-thread blocks, partial batches
])
def test_cuda_kernel_matches_plain(cuda_device, seed, n, opacity_range, tile):
    stream, starts, gx, gy = sorted_stream(cuda_device, seed, n,
                                           opacity_range, tile)
    before = tk.launches
    got = tk.composite_fwd(stream, starts, gx, gy, tile, tile)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    want = composite_tiles_torch(stream, starts, gx, gy, tile, tile)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got[:, 0:4], want[:, 0:4], atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=2e-4)
    np.testing.assert_allclose(got[:, 5], want[:, 5], atol=1.0)
    np.testing.assert_array_equal(got[:, 6:], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,opacity_range,tile", [
    (0, 150, (0.2, 0.95), 16),
    (1, 300, (0.9, 0.99), 16),      # near-opaque: the whole-tile early exit
    (2, 150, (0.2, 0.95), 8),       # 64-thread blocks, partial batches
    (3, 100, (0.2, 0.95), 5),       # 25 pixels: a partial warp
])
def test_cuda_backward_kernel_matches_plain(cuda_device, seed, n,
                                            opacity_range, tile):
    """Per-pair gradients at the tolerance of tests/test_tile_kernels.py:
    atol 1e-5·max|plain|, rtol 1e-4; exact zeros where nothing is written."""
    stream, starts, gx, gy = sorted_stream(cuda_device, seed, n,
                                           opacity_range, tile)
    out = tk.composite_fwd(stream, starts, gx, gy, tile, tile)
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=cuda_device)
    dout[:, 5:] = 0.0
    before = tk.bwd_launches
    got = tk.composite_bwd(stream, starts, out, dout, gx, gy, tile, tile)
    torch.cuda.synchronize()
    assert tk.bwd_launches == before + 1
    want = composite_tiles_bwd_torch(stream, starts, out, dout, gx, gy, tile,
                                     tile)
    n_pairs = int(starts[-1])
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = max(np.abs(want[:, :n_pairs]).max(), 1e-6)
    np.testing.assert_allclose(got[:, :n_pairs], want[:, :n_pairs],
                               atol=1e-5 * scale, rtol=1e-4)
    np.testing.assert_array_equal(got[:, n_pairs:], 0.0)
    np.testing.assert_array_equal(got[10:], 0.0)
    again = tk.composite_bwd(stream, starts, out, dout, gx, gy, tile, tile)
    np.testing.assert_array_equal(again.cpu().numpy(), got)   # no atomics


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    stream, starts, gx, gy = sorted_stream(cuda_device, 0, 50, (0.2, 0.9), 16)
    with pytest.raises(TypeError):
        tk.composite_fwd(stream.double(), starts, gx, gy, 16, 16)
    with pytest.raises(TypeError):
        tk.composite_fwd(stream, starts.long(), gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_fwd(stream[:, ::2], starts, gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_fwd(stream, starts.cpu(), gx, gy, 16, 16)
    before = tk.launches
    with pytest.raises(ValueError):        # 48x48 = 2,304 threads per block
        tk.composite_fwd(stream, starts[:3], 2, 1, 48, 48)
    assert tk.launches == before
    out = tk.composite_fwd(stream, starts, gx, gy, 16, 16)
    before = tk.bwd_launches
    with pytest.raises(TypeError):
        tk.composite_bwd(stream, starts, out, out.double(), gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_bwd(stream, starts, out, out.transpose(1, 2)
                         .contiguous().transpose(1, 2), gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_bwd(stream, starts, out, out.cpu(), gx, gy, 16, 16)
    assert tk.bwd_launches == before
