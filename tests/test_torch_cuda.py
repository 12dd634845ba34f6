"""The CUDA compositors, forward and backward, vs their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so that on a GPU machine without
jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of ``tests/test_tile_kernels.py``: rgb/depth atol
5e-4 rtol 1e-4, final_T atol 2e-4, n_contrib within 1; per-pair
gradients atol 1e-5·max|plain|, rtol 1e-4.  The backward must also be
bit-identical on repeat (no atomics).
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
    before = tk.launches["composite_fwd"]
    got = tk.composite_fwd(stream, starts, gx, gy, tile, tile)
    torch.cuda.synchronize()
    assert tk.launches["composite_fwd"] == before + 1
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
    before = tk.launches["composite_bwd"]
    got = tk.composite_bwd(stream, starts, out, dout, gx, gy, tile, tile)
    torch.cuda.synchronize()
    assert tk.launches["composite_bwd"] == before + 1
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
    before = tk.launches["composite_fwd"]
    with pytest.raises(ValueError):        # 48x48 = 2,304 threads per block
        tk.composite_fwd(stream, starts[:3], 2, 1, 48, 48)
    assert tk.launches["composite_fwd"] == before
    out = tk.composite_fwd(stream, starts, gx, gy, 16, 16)
    before = tk.launches["composite_bwd"]
    with pytest.raises(TypeError):
        tk.composite_bwd(stream, starts, out, out.double(), gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_bwd(stream, starts, out, out.transpose(1, 2)
                         .contiguous().transpose(1, 2), gx, gy, 16, 16)
    with pytest.raises(ValueError):
        tk.composite_bwd(stream, starts, out, out.cpu(), gx, gy, 16, 16)
    assert tk.launches["composite_bwd"] == before


def synthetic_stream(dev, seed, counts, grid, tile_x, tile_y, opacity_range,
                     sigma_range=(1.0, 6.0), pad=7):
    """A [16, M] pair stream with counts[t] pairs for tile t (row-major
    tiles of a grid (gx, gy)), each a Gaussian centred on or near its tile,
    and `pad` zero slots past the last range.  The compositors take the
    pairs in the order given, so no depth sort is needed."""
    rng = np.random.default_rng(seed)
    gx, gy = grid
    assert len(counts) == gx * gy
    n = int(sum(counts))
    tiles = np.repeat(np.arange(gx * gy), counts)
    cx = (tiles % gx) * tile_x + rng.uniform(-4, tile_x + 4, n)
    cy = (tiles // gx) * tile_y + rng.uniform(-4, tile_y + 4, n)
    sx, sy = (rng.uniform(*sigma_range, n) for _ in range(2))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    # conic = inverse of R diag(sx^2, sy^2) R^T
    ia, ib = 1 / sx ** 2, 1 / sy ** 2
    conic = np.stack([c * c * ia + s * s * ib, c * s * (ia - ib),
                      s * s * ia + c * c * ib], 0)
    feat = np.zeros((16, n + pad), np.float32)
    feat[0, :n], feat[1, :n] = cx, cy
    feat[2:5, :n] = conic
    feat[5, :n] = rng.uniform(*opacity_range, n)
    feat[6:9, :n] = rng.random((3, n))
    feat[9, :n] = rng.uniform(1, 10, n)
    feat[10, :n] = 1.0
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (torch.tensor(feat, device=dev), torch.tensor(starts, device=dev),
            gx, gy)


def check_both_kernels(dev, stream, starts, gx, gy, tile_x, tile_y, seed):
    """Both kernels vs their plain versions; the backward bit-identical on
    repeat and exactly 0 where nothing is written."""
    got = tk.composite_fwd(stream, starts, gx, gy, tile_x, tile_y)
    want = composite_tiles_torch(stream, starts, gx, gy, tile_x, tile_y)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(g[:, 0:4], w[:, 0:4], atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(g[:, 4], w[:, 4], atol=2e-4)
    np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1.0)
    np.testing.assert_array_equal(g[:, 6:], 0.0)

    gen = torch.Generator(device=dev).manual_seed(seed)
    dout = torch.randn(got.shape, generator=gen, device=dev)
    dout[:, 5:] = 0.0
    gk = tk.composite_bwd(stream, starts, got, dout, gx, gy, tile_x, tile_y)
    gp = composite_tiles_bwd_torch(stream, starts, got, dout, gx, gy, tile_x,
                                   tile_y)
    n_pairs = int(starts[-1])
    gk_np, gp_np = gk.cpu().numpy(), gp.cpu().numpy()
    scale = max(np.abs(gp_np[:, :n_pairs]).max(initial=0.0), 1e-6)
    np.testing.assert_allclose(gk_np[:, :n_pairs], gp_np[:, :n_pairs],
                               atol=1e-5 * scale, rtol=1e-4)
    np.testing.assert_array_equal(gk_np[:, n_pairs:], 0.0)
    np.testing.assert_array_equal(gk_np[10:], 0.0)
    again = tk.composite_bwd(stream, starts, got, dout, gx, gy, tile_x,
                             tile_y)
    np.testing.assert_array_equal(again.cpu().numpy(), gk_np)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x,tile_y,grid,counts,opacity_range,sigma", [
    pytest.param(16, 8, (3, 2), (40, 0, 133, 7, 300, 65), (0.2, 0.95),
                 (1.0, 6.0), id="non_square_16x8"),
    pytest.param(5, 5, (2, 2), (9, 30, 0, 61), (0.2, 0.95), (1.0, 6.0),
                 id="partial_warp_5x5"),
    pytest.param(7, 9, (2, 2), (1, 50, 129, 3), (0.2, 0.95), (1.0, 6.0),
                 id="odd_7x9"),
    pytest.param(16, 16, (2, 2), (0, 0, 45, 0), (0.2, 0.95), (1.0, 6.0),
                 id="empty_tiles"),
    # not multiples of the unroll (4) or of the batch (128)
    pytest.param(16, 16, (5, 2), (1, 2, 3, 5, 127, 129, 131, 255, 257, 259),
                 (0.05, 0.3), (1.0, 6.0), id="ragged_counts"),
    # pixels saturate after a few pairs, at every position of a group of
    # 4; the 300-pair tile leaves through the whole-tile exit
    pytest.param(16, 16, (2, 2), (67, 300, 5, 131), (0.9, 0.99),
                 (4.0, 12.0), id="early_exit_in_group"),
    # faint pairs: no pixel saturates, every batch is read and the ring
    # wraps several times
    pytest.param(16, 16, (3, 1), (700, 650, 613), (0.005, 0.02),
                 (2.0, 10.0), id="multi_stage"),
    # an odd tile whose ranges read one to six ring stages
    pytest.param(7, 9, (3, 2), (0, 3, 130, 257, 700, 61), (0.02, 0.6),
                 (1.0, 6.0), id="odd_multi_stage"),
])
def test_cuda_tile_shapes_and_ranges_match_plain(cuda_device, tile_x, tile_y,
                                                 grid, counts, opacity_range,
                                                 sigma):
    stream, starts, gx, gy = synthetic_stream(cuda_device, 11, counts, grid,
                                              tile_x, tile_y, opacity_range,
                                              sigma)
    check_both_kernels(cuda_device, stream, starts, gx, gy, tile_x, tile_y,
                       seed=5)



# ---------------------------------------------------------------------------
# density control on the card
# ---------------------------------------------------------------------------

DENSITY_CAP = 4096
DENSITY_BASE = dict(grad_threshold=2e-4, opacity_threshold=0.005,
                    scene_extent=1.0, percent_dense=0.01,
                    max_screen_size=None, max_points=2_000_000)
DENSITY_CASES = {
    "mixed": {},
    "size_prune_cap": dict(max_screen_size=20.0, size_prune_cap=0.05,
                           scene_extent=3.0),
    "world_prune": dict(grad_threshold=1e30, world_prune=True,
                        scene_extent=5.0),
    "exhausted": dict(grad_threshold=1e-5, alive_frac=0.93),
}


def density_inputs(seed, alive_frac=0.6, cap=DENSITY_CAP):
    """numpy pool fields, Adam rows, statistics and split noise of a
    mid-training pool (as tests/test_torch_density.py builds them)."""
    rng = np.random.default_rng(seed)
    alive = rng.random(cap) < alive_frac
    rot = rng.normal(size=(cap, 4)).astype(np.float32)
    rot[~alive] = [1, 0, 0, 0]
    pool = {"xyz": rng.normal(0, 4, (cap, 3)),
            "features_dc": rng.normal(size=(cap, 1, 3)),
            "features_rest": rng.normal(0, 0.2, (cap, 15, 3)),
            "scaling": rng.uniform(-6.0, 0.0, (cap, 3)),
            "rotation": rot, "opacity": rng.normal(-1.0, 2.5, (cap, 1))}
    pool = {k: np.asarray(v, np.float32) for k, v in pool.items()}
    pool["alive"] = alive
    names = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
             "scaling": "scaling", "rotation": "rotation",
             "opacity": "opacity"}
    rows = {g: (rng.normal(0, 1e-3, pool[f].shape).astype(np.float32),
                np.abs(rng.normal(0, 1e-6, pool[f].shape)).astype(np.float32))
            for g, f in names.items()}
    denom = rng.integers(0, 6, cap).astype(np.float32)
    stats = {"max_radii2d": rng.uniform(0, 40, cap).astype(np.float32),
             "xyz_grad_accum": (denom * rng.uniform(0, 4e-4, cap)).astype(
                 np.float32),
             "denom": denom}
    noise = rng.normal(size=(2, cap, 3)).astype(np.float32)
    return pool, rows, stats, noise


def density_on(dev, pool, rows, stats):
    from s3gaussian_tpu_torch.models import pool as tpool

    def t(x):
        return torch.tensor(x, device=dev)

    return (tpool.GaussianPool(**{k: t(v) for k, v in pool.items()}),
            {g: (t(m), t(v)) for g, (m, v) in rows.items()},
            tpool.PoolStats(**{k: t(v) for k, v in stats.items()}))


def assert_density_close(got, want):
    """Counts, masks and moments exact; floats atol 1e-6·max|CPU|."""
    gp, grows, gstats, ginfo = got
    wp, wrows, wstats, winfo = want
    assert {k: int(v) for k, v in ginfo.items()} == \
        {k: int(v) for k, v in winfo.items()}
    np.testing.assert_array_equal(gp.alive.cpu().numpy(), wp.alive.numpy())
    for g, v in wp.param_dict().items():
        w = v.numpy()
        np.testing.assert_allclose(gp.param_dict()[g].cpu().numpy(), w,
                                   rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=g)
        for a, b in zip(grows[g], wrows[g]):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                          err_msg=g)
    for f in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(gstats, f).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DENSITY_CASES))
def test_cuda_densify_and_prune_matches_cpu(cuda_device, case):
    """The same call on the card and on the CPU with the same noise; no
    index outside [0, Nc) reaches an indexing operator on the card."""
    from s3gaussian_tpu_torch.models import pool as tpool
    from torch_index_bounds import IndexBounds

    kw = dict(DENSITY_BASE, **DENSITY_CASES[case])
    pool, rows, stats, noise = density_inputs(
        sorted(DENSITY_CASES).index(case), kw.pop("alive_frac", 0.6))
    want = tpool.densify_and_prune(*density_on("cpu", pool, rows, stats),
                                   tuple(torch.tensor(noise)), **kw)
    with IndexBounds() as bounds:
        got = tpool.densify_and_prune(
            *density_on(cuda_device, pool, rows, stats),
            tuple(torch.tensor(noise, device=cuda_device)), **kw)
        torch.cuda.synchronize()
    bounds.assert_within(DENSITY_CAP)
    assert got[0].xyz.device.type == cuda_device.type
    assert_density_close(got, want)
    info = {k: int(v) for k, v in want[3].items()}
    assert info["n_cloned"] + info["n_split"] + info["n_pruned"] > 0
    if case == "exhausted":
        assert info["overflow"] > 0


@pytest.mark.cuda
def test_cuda_densify_and_prune_never_waits_for_the_host(cuda_device):
    """No operation of densify_and_prune synchronises with the host: the
    counts stay 0-d tensors on the card until the caller reads them."""
    from s3gaussian_tpu_torch.models import pool as tpool

    kw = dict(DENSITY_BASE, **DENSITY_CASES["size_prune_cap"])
    pool, rows, stats, noise = density_inputs(3)
    args = density_on(cuda_device, pool, rows, stats)
    noise = tuple(torch.tensor(noise, device=cuda_device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, _, info = tpool.densify_and_prune(*args, noise, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.device.type == "cuda" and v.dim() == 0
               for v in info.values())
    assert int(info["n_pruned"]) > 0


@pytest.mark.cuda
def test_cuda_densify_step_draws_its_noise_on_the_card(cuda_device):
    """densify_step draws the split noise from a generator on the card and
    edits the state there; the same draws on the CPU give the same
    result."""
    from s3gaussian_tpu_torch.models import pool as tpool
    from s3gaussian_tpu_torch.train.optim import AdamState
    from s3gaussian_tpu_torch.train.trainer import TrainState, densify_step
    from s3gaussian_tpu_torch.config import OptimizationParams

    pool, rows, stats, _ = density_inputs(7)
    p, r, s = density_on(cuda_device, pool, rows, stats)
    zero = torch.zeros((), dtype=torch.int32, device=cuda_device)
    state = TrainState(
        pool=p, deform=None,
        adam=AdamState(mu={"pool": {g: m for g, (m, _) in r.items()},
                           "deform": {}},
                       nu={"pool": {g: v for g, (_, v) in r.items()},
                           "deform": {}}, count=zero + 3),
        stats=s, step=zero + 40, aabb=torch.zeros(2, 3, device=cuda_device),
        nan_skips=zero)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    new, info = densify_step(state, gen, 2e-4, 0.005, 1.0, 20.0,
                             OptimizationParams())
    noise = torch.randn((2, DENSITY_CAP, 3), device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(5)).cpu()
    want = tpool.densify_and_prune(*density_on("cpu", pool, rows, stats),
                                   (noise[0], noise[1]), 2e-4, 0.005, 1.0,
                                   0.01, 20.0, 2_000_000)
    got_rows = {g: (new.adam.mu["pool"][g], new.adam.nu["pool"][g])
                for g in rows}
    assert_density_close((new.pool, got_rows, new.stats, info), want)
    assert int(new.step) == 40 and int(new.adam.count) == 3


# --- the evaluation sweep's metrics and rig render on the card -----------

@pytest.fixture
def tf32_on():
    """TF32 switched on globally, as a caller that never ran
    ``configure_device`` may leave it; restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def near_pair(seed, h=120, w=200):
    rng = np.random.default_rng(seed)
    gt = rng.random((h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 2e-3, gt.shape), 0, 1).astype(
        np.float32)
    mask = rng.random((h, w)) < 0.3
    return pred, gt, mask


def rand_alex_weights(rng):
    """AlexNet's feature stack at its real widths (64, 192, 384, 256, 256),
    random, in the naming of the LPIPS ``.npz``."""
    wts, in_ch = {}, 3
    for j, (name, out, k) in enumerate((("net.slice1.0", 64, 11),
                                        ("net.slice2.3", 192, 5),
                                        ("net.slice3.6", 384, 3),
                                        ("net.slice4.8", 256, 3),
                                        ("net.slice5.10", 256, 3))):
        wts[f"{name}.weight"] = rng.normal(
            0, 1 / np.sqrt(in_ch * k * k), (out, in_ch, k, k)).astype(
                np.float32)
        wts[f"{name}.bias"] = rng.normal(0, 0.01, out).astype(np.float32)
        wts[f"lin{j}.weight"] = np.abs(rng.normal(
            0, 0.1, (1, out, 1, 1))).astype(np.float32)
        in_ch = out
    return wts


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_ssim_is_exact_with_tf32_on(cuda_device, tf32_on, seed):
    """SSIM and masked SSIM of a near-identical pair (the variances cancel)
    from float32 inputs on the card against float64 inputs on the CPU."""
    from s3gaussian_tpu_torch.eval.metrics import masked_ssim, ssim_skimage

    pred, gt, mask = near_pair(seed)
    on = [torch.tensor(x, device=cuda_device) for x in (pred, gt, mask)]
    ref = [torch.tensor(x).double() if x.dtype != bool else torch.tensor(x)
           for x in (pred, gt, mask)]
    np.testing.assert_allclose(float(ssim_skimage(*on[:2])),
                               float(ssim_skimage(*ref[:2])), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(masked_ssim(*on)),
                               float(masked_ssim(*ref)), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_lpips_is_exact_with_tf32_on(cuda_device, tf32_on, tmp_path,
                                          monkeypatch):
    """LPIPS with AlexNet-width random weights on the card against the
    CPU in float32, and the TF32 flag as it was afterwards."""
    from s3gaussian_tpu_torch.eval.lpips import lpips

    path = tmp_path / "alex.npz"
    np.savez(path, **rand_alex_weights(np.random.default_rng(0)))
    monkeypatch.setenv("S3G_LPIPS_WEIGHTS", str(path))
    pred, gt, _ = near_pair(2, 128, 192)
    pred = np.clip(pred + np.random.default_rng(3).normal(
        0, 0.05, pred.shape), 0, 1).astype(np.float32)
    got = lpips(torch.tensor(pred, device=cuda_device),
                torch.tensor(gt, device=cuda_device))
    want = lpips(torch.tensor(pred), torch.tensor(gt))
    assert torch.backends.cudnn.allow_tf32
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_render_multicam_equals_per_camera_renders(cuda_device):
    """The rig render on the card (one deformation evaluation, the CUDA
    compositor) against render() per camera, with the decomposition."""
    from s3gaussian_tpu_torch.config import ModelHiddenParams, PipelineParams
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.render.renderer import render, render_multicam

    rng = np.random.default_rng(4)
    n = 2000
    tan = math.tan(0.5)
    z = rng.uniform(1.5, 8.0, n)
    pts = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                    rng.uniform(-0.9, 0.9, n) * tan * z, z], 1)
    pool = create_from_pcd(pts.astype(np.float32),
                           rng.random((n, 3)).astype(np.float32), 2048,
                           device=cuda_device)
    hp = ModelHiddenParams(net_width=16, multires=[1, 2],
                           kplanes_config={"grid_dimensions": 2,
                                           "input_coordinate_dim": 4,
                                           "output_coordinate_dim": 8,
                                           "resolution": [8, 8, 8, 5]})
    deform = DeformationField(hp, torch.Generator().manual_seed(0),
                              cuda_device)
    cams = []
    for yaw in (-20.0, 0.0, 20.0):
        a = np.deg2rad(yaw)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cams.append(make_camera(R, np.array([0.2, -0.1, 0.3]), 1.0, 0.8, W,
                                H, time=0.6, device=cuda_device))
    cfg = RasterConfig(max_visible=2048, pair_budget=1 << 18)
    args = (pool, deform, PipelineParams(), torch.zeros(3, device=cuda_device),
            torch.tensor([[6.0, 6.0, 9.0], [-6.0, -6.0, 0.0]],
                         device=cuda_device), 3)
    before = tk.launches["composite_fwd"]
    with torch.no_grad():
        rig = render_multicam(cams, *args, return_decomposition=True, cfg=cfg)
        assert tk.launches["composite_fwd"] - before == 9
        for b, cam in enumerate(cams):
            one = render(cam, *args, return_decomposition=True, cfg=cfg)
            for k in ("render", "depth", "render_d", "render_s"):
                np.testing.assert_allclose(rig[k][b].cpu().numpy(),
                                           one[k].cpu().numpy(), rtol=1e-4,
                                           atol=5e-4, err_msg=k)
    assert int(rig["raster_aux"]["n_pairs"]) > 0


# --- the cull, two-class emission and the rig step on the card ----------

@pytest.mark.cuda
@pytest.mark.parametrize("nr", [40, 90])     # below and above the visible
def test_cuda_take_compact_matches_cpu(cuda_device, nr):
    """Candidates, gather and rank backward on the card equal the CPU's
    exactly."""
    from s3gaussian_tpu_torch.ops.compact import candidates, take_compact

    rng = np.random.default_rng(nr)
    x = rng.normal(size=(100, 1, 3)).astype(np.float32)
    vis = rng.random(100) < 0.6
    g = rng.normal(size=(nr, 1, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        v = torch.tensor(vis, device=dev)
        cand = candidates(v, nr)
        y = take_compact(xt, cand, v)
        (gx,) = torch.autograd.grad(y, [xt], torch.tensor(g, device=dev))
        out[str(dev)] = [a.detach().cpu().numpy() for a in (cand, y, gx)]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(b, a)


def frustum_inputs(seed, n, scale_range):
    rng = np.random.default_rng(seed)
    tan = math.tan(0.5)
    z = rng.uniform(1.5, 8.0, n)
    means = np.stack([rng.uniform(-0.9, 0.9, n) * tan * z,
                      rng.uniform(-0.9, 0.9, n) * tan * z, z], 1)
    q = rng.normal(size=(n, 4))
    return [np.asarray(a, np.float32) for a in (
        means, rng.uniform(*scale_range, (n, 3)),
        q / np.linalg.norm(q, axis=1, keepdims=True),
        rng.uniform(0.2, 0.95, n), rng.random((n, 3)))]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [512, 16])     # all bigs granted; demoted
def test_cuda_two_class_rasterize_matches_cpu(cuda_device, budget):
    """rasterize with two-class emission on the card (the CUDA
    compositors) against the CPU (the plain ones): forward at the
    compositor tolerances, every input gradient atol 2e-5·max|CPU| rtol
    2e-4, the counters exact."""
    from s3gaussian_tpu_torch.ops.rasterizer import rasterize

    arrays = frustum_inputs(3, 600, (0.02, 0.4))
    tan = math.tan(0.5)
    view = np.eye(4, dtype=np.float32)
    full = view @ projection_matrix(0.01, 100.0, 1.0, 1.0).T
    cfg = RasterConfig(tile_x=8, tile_y=8, max_visible=600, rect_w=8,
                       rect_h=8, big_budget=budget, pair_budget=1 << 20)
    tgt = np.random.default_rng(0).random((3, H, W)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_device):
        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)
        leaves = [t(a).requires_grad_(True) for a in arrays]
        means, scales, quats, opac, colors = leaves
        settings = RasterSettings(H, W, tan, tan, t(np.zeros(3)), 1.0,
                                  t(view), t(full), 0, t(np.zeros(3)))
        before = tk.launches["composite_bwd"]
        color, radii, depth, aux = rasterize(settings, means, opac,
                                             scales=scales, rotations=quats,
                                             colors_precomp=colors, cfg=cfg)
        loss = ((color - t(tgt)) ** 2).sum() + 0.1 * depth.sum()
        grads = torch.autograd.grad(loss, leaves)
        if str(dev) != "cpu":
            assert tk.launches["composite_bwd"] == before + 1
        res[str(dev)] = ([x.detach().cpu().numpy() for x in
                          (color, depth, radii) + grads],
                         {k: int(aux[k]) for k in (
                             "n_pairs", "overflow_rect", "overflow_pairs")})
    (want, want_aux), (got, got_aux) = res["cpu"], res[str(cuda_device)]
    assert got_aux == want_aux and want_aux["n_pairs"] > 0
    if budget == 16:
        assert want_aux["overflow_rect"] > 0
    for name, a, b in zip(("color", "depth"), want, got):
        np.testing.assert_allclose(b, a, atol=5e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[2], want[2])
    for name, a, b in zip(("means", "scales", "quats", "opacity", "colors"),
                          want[3:], got[3:]):
        np.testing.assert_allclose(b, a, atol=2e-5 * np.abs(a).max(),
                                   rtol=2e-4, err_msg=name)


@pytest.mark.cuda
def test_cuda_culled_rig_step_matches_cpu(cuda_device):
    """A rig step (3 yawed cameras at one time) with the union cull and
    two-class emission on the card and on the CPU from one state: the
    loss rtol 1e-4, each tensor's update atol 1e-3·max|update| rtol 1e-2
    (chip_smoke.py's train-step tolerances), radii, visibility and
    vis_count exact; one forward and one backward launch a camera."""
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams)
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train.trainer import (init_state,
                                                    train_step_multicam)

    rng = np.random.default_rng(8)
    n = 1500
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(2.0, 8.0, n)
    pts = np.stack([rad * np.sin(ang), rng.uniform(-1.0, 1.0, n),
                    rad * np.cos(ang)], 1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    images = rng.random((3, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1, 8, (3, H, W)).astype(np.float32)
    hp = ModelHiddenParams(net_width=16, multires=[1, 2],
                           kplanes_config={"grid_dimensions": 2,
                                           "input_coordinate_dim": 4,
                                           "output_coordinate_dim": 8,
                                           "resolution": [8, 8, 8, 5]})
    cfg = RasterConfig(max_visible=1024, pair_budget=1 << 18, rect_w=8,
                       rect_h=8, tile_x=8, tile_y=8, big_budget=128,
                       cull_before_deform=True)
    out = {}
    for dev in ("cpu", cuda_device):
        pool = create_from_pcd(pts, cols, 2048, device=dev)
        state = init_state(pool, DeformationField(
            hp, torch.Generator().manual_seed(0), dev),
            torch.tensor([[9.0, 9.0, 9.0], [-9.0, -9.0, -9.0]], device=dev))
        before = {k: v.detach().cpu().clone() for k, v in
                  state.pool.param_dict().items()}
        cams = []
        for b, yaw in enumerate((-40.0, 0.0, 40.0)):
            a = np.deg2rad(yaw)
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]])
            cams.append(make_camera(R, np.zeros(3), 1.0, 0.8, W, H, time=0.4,
                                    image=images[b], depth_map=depths[b],
                                    device=dev))
        launches = tk.compositor_launches()
        state, aux = train_step_multicam(state, cams, "fine", 3, hp,
                                         OptimizationParams(),
                                         PipelineParams(), cfg, 5.0,
                                         torch.zeros(3, device=dev))
        if str(dev) != "cpu":
            assert (tk.launches["composite_fwd"] - launches[0],
                    tk.launches["composite_bwd"] - launches[1]) == (3, 3)
        out[str(dev)] = (aux, {k: v.detach().cpu() - before[k] for k, v in
                               state.pool.param_dict().items()})
    (want_aux, want), (got_aux, got) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(got_aux["metrics"]["loss"].item(),
                               want_aux["metrics"]["loss"].item(), rtol=1e-4)
    for k in ("radii", "visible", "vis_count"):
        np.testing.assert_array_equal(got_aux[k].cpu().numpy(),
                                      want_aux[k].numpy(), err_msg=k)
    assert int(want_aux["visible"].sum()) < n      # the cull left rows out
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-3 * np.abs(w).max(), rtol=1e-2,
                                   err_msg=k)


@pytest.mark.cuda
def test_cuda_nccl_world_of_one_step_matches_train_step(cuda_device,
                                                        tmp_path):
    """``parallel_train_step`` under NCCL at world size 1 (a file store)
    against ``train_step`` on the card from one state: the loss rtol 1e-4,
    each tensor's update atol 1e-3·max|update| rtol 1e-2 (chip_smoke.py's
    train-step tolerances: the per-rank backward accumulates with
    atomics) from mid-training moments, radii and visibility exact; one
    forward and one backward launch each."""
    import torch.distributed as dist

    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams)
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.parallel.data_parallel import \
        parallel_train_step
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost
    from s3gaussian_tpu_torch.train.trainer import init_state, train_step

    rng = np.random.default_rng(9)
    n = 1500
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 8, n)], 1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    image = rng.random((H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 8, (H, W)).astype(np.float32)
    hp = ModelHiddenParams(net_width=16, multires=[1, 2],
                           kplanes_config={"grid_dimensions": 2,
                                           "input_coordinate_dim": 4,
                                           "output_coordinate_dim": 8,
                                           "resolution": [8, 8, 8, 5]})
    cfg = RasterConfig(max_visible=2048, pair_budget=1 << 18, rect_w=8,
                       rect_h=8, tile_x=8, tile_y=8)
    assert init_multihost("file://" + str(tmp_path / "store"), 1, 0,
                          device="cuda") == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        out = {}
        for name, step in (("one", train_step), ("dp", parallel_train_step)):
            pool = create_from_pcd(pts, cols, 2048, device=cuda_device)
            state = init_state(pool, DeformationField(
                hp, torch.Generator().manual_seed(0), cuda_device),
                torch.tensor([[9.0] * 3, [-9.0] * 3], device=cuda_device))
            # mid-training moments: the update then moves smoothly with
            # the gradient (at count 0 Adam's first step is lr·sign(g))
            mrng = np.random.default_rng(3)
            for tree, scale in ((state.adam.mu, 1e-3), (state.adam.nu, 1e-6)):
                for d in tree.values():
                    for v in d.values():
                        x = mrng.normal(size=tuple(v.shape)) * scale
                        v.copy_(torch.from_numpy(np.abs(x) if scale < 1e-4
                                                 else x))
            state.adam.count.fill_(5)
            before = {k: v.detach().cpu().clone() for k, v in
                      state.pool.param_dict().items()}
            cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W, H,
                              time=0.4, image=image, depth_map=depth,
                              device=cuda_device)
            launches = tk.compositor_launches()
            state, aux = step(state, cam, "fine", 3, hp,
                              OptimizationParams(), PipelineParams(), cfg,
                              5.0, torch.zeros(3, device=cuda_device))
            assert (tk.launches["composite_fwd"] - launches[0],
                    tk.launches["composite_bwd"] - launches[1]) == (1, 1)
            out[name] = (aux, {k: v.detach().cpu() - before[k] for k, v in
                               state.pool.param_dict().items()})
    finally:
        dist.destroy_process_group()
    (want_aux, want), (got_aux, got) = out["one"], out["dp"]
    np.testing.assert_allclose(got_aux["metrics"]["loss"].item(),
                               want_aux["metrics"]["loss"].item(), rtol=1e-4)
    for k in ("radii", "visible"):
        np.testing.assert_array_equal(got_aux[k].cpu().numpy(),
                                      want_aux[k].cpu().numpy(), err_msg=k)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-3 * np.abs(w).max(), rtol=1e-2,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the train step as a captured CUDA graph (train/graphs.py)
# --------------------------------------------------------------------------

def _graph_setup(dev, seed=10):
    """A small mid-training state on ``dev`` and its settings: (state,
    step arguments after the stage)."""
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams)
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train.trainer import init_state

    rng = np.random.default_rng(seed)
    n = 1500
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 8, n)], 1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    hp = ModelHiddenParams(net_width=16, multires=[1, 2],
                           kplanes_config={"grid_dimensions": 2,
                                           "input_coordinate_dim": 4,
                                           "output_coordinate_dim": 8,
                                           "resolution": [8, 8, 8, 5]})
    cfg = RasterConfig(max_visible=2048, pair_budget=1 << 18, rect_w=8,
                       rect_h=8, tile_x=8, tile_y=8)
    state = init_state(create_from_pcd(pts, cols, 2048, device=dev),
                       DeformationField(hp, torch.Generator().manual_seed(0),
                                        dev),
                       torch.tensor([[9.0] * 3, [-9.0] * 3], device=dev))
    mrng = np.random.default_rng(3)
    for tree, scale in ((state.adam.mu, 1e-3), (state.adam.nu, 1e-6)):
        for d in tree.values():
            for v in d.values():
                x = mrng.normal(size=tuple(v.shape)) * scale
                v.copy_(torch.from_numpy(np.abs(x) if scale < 1e-4 else x))
    state.adam.count.fill_(5)
    return state, (3, hp, OptimizationParams(), PipelineParams(), cfg, 5.0,
                   torch.zeros(3, device=dev))


def _graph_cameras(dev, n, seed=20):
    """Cameras that differ in yaw, time, field of view and target."""
    from s3gaussian_tpu_torch.data.cameras import make_camera

    rng = np.random.default_rng(seed)
    cams = []
    for i in range(n):
        a = np.deg2rad(8.0 * (i % 3 - 1))
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cams.append(make_camera(
            R, np.zeros(3), 1.0 + 0.05 * (i % 3), 0.8 - 0.04 * (i % 2), W, H,
            time=0.3 + 0.1 * i,
            image=rng.random((H, W, 3)).astype(np.float32),
            depth_map=rng.uniform(1, 8, (H, W)).astype(np.float32),
            device=dev))
    return cams


def _copy(state):
    from s3gaussian_tpu_torch.train.graphs import clone_state
    return clone_state(state)


def _assert_updates_close(got, want, start):
    """chip_smoke.py's train-step tolerances on each parameter's update."""
    from s3gaussian_tpu_torch.train.trainer import param_tree
    g, w = (param_tree(s.pool, s.deform) for s in (got, want))
    for grp, d in start.items():
        for k, s0 in d.items():
            dw = (w[grp][k].detach().cpu() - s0).double()
            dg = (g[grp][k].detach().cpu() - s0).double()
            np.testing.assert_allclose(dg.numpy(), dw.numpy(),
                                       atol=1e-3 * float(dw.abs().max()),
                                       rtol=1e-2, err_msg=f"{grp}.{k}")
    assert int(got.step) == int(want.step)
    assert int(got.adam.count) == int(want.adam.count)


def _start(state):
    from s3gaussian_tpu_torch.train.trainer import param_tree
    return {g: {k: v.detach().cpu().clone() for k, v in d.items()}
            for g, d in param_tree(state.pool, state.deform).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rig", [False, True])
def test_cuda_block_of_replays_matches_eager_steps(cuda_device, rig):
    """A block of 5 replays (``train_steps_scan``, or 5 rigs of 3 through
    ``train_steps_scan_multicam``) against as many eager steps from one
    state: each step's loss rtol 1e-4, each parameter's update
    chip_smoke.py's tolerances, the last step's visibility equal but for
    0.1% of the rows; one forward and one backward launch a camera
    captured, counted once a replay."""
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr

    state, args = _graph_setup(cuda_device)
    cams = _graph_cameras(cuda_device, 15 if rig else 5)
    views = [cams[3 * i:3 * i + 3] for i in range(5)] if rig else cams
    b = 3 if rig else 1
    start = _start(state)
    eager = _copy(state)
    losses = []
    for v in views:
        eager, aux = (tr.train_step_multicam if rig else tr.train_step)(
            eager, v, "fine", *args)
        losses.append(aux["metrics"]["loss"].item())
    eager_vis = aux["visible"].cpu()
    graphs.release()
    launches = tk.compositor_launches()
    try:
        if rig:
            got, gaux = tr.train_steps_scan_multicam(state, views, 3, "fine",
                                                     *args)
        else:
            got, gaux = tr.train_steps_scan(state, views, "fine", *args)
        torch.cuda.synchronize()
        g = graphs.current()
        assert got is state and g.state is state and g.replays == 5
        assert tk.compositor_launches(g.captured) == (b, b)
        # 5 replays and the capture's warm-up step
        assert (tk.launches["composite_fwd"] - launches[0],
                tk.launches["composite_bwd"] - launches[1]) == (6 * b, 6 * b)
        # the last replay's visibility, in the graph's own outputs
        assert int((g.out["visible"].cpu() != eager_vis).sum()) <= max(
            1, eager_vis.numel() // 1000)
    finally:
        graphs.release()
    np.testing.assert_allclose(gaux["metrics"]["loss"].cpu().numpy(), losses,
                               rtol=1e-4)
    assert gaux["n_pairs"].shape == (5,) and int(gaux["n_pairs"].min()) > 0
    _assert_updates_close(got, eager, start)


@pytest.mark.cuda
def test_cuda_load_after_densify(cuda_device):
    """A densify between two blocks: the second block loads the new pool
    rows into the held graph's static state (no recapture, the static
    tensors stay where they were) and equals eager steps from the
    densified state."""
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors

    state, args = _graph_setup(cuda_device, seed=11)
    cams = _graph_cameras(cuda_device, 6, seed=21)
    graphs.release()
    try:
        state, _ = tr.train_steps_scan(state, cams[:3], "fine", *args)
        g = graphs.current()
        where = {k: v.data_ptr() for k, v in state_tensors(state).items()}
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        dens, info = tr.densify_step(state, gen, 1e-5, 0.005, 5.0, None,
                                     args[2])
        assert int(info["n_cloned"]) + int(info["n_split"]) > 0
        start = _start(dens)
        eager = _copy(dens)
        for c in cams[3:]:
            eager, _ = tr.train_step(eager, c, "fine", *args)
        got, _ = tr.train_steps_scan(dens, cams[3:], "fine", *args)
        torch.cuda.synchronize()
        assert graphs.current() is g and got is g.state
        assert {k: v.data_ptr() for k, v in
                state_tensors(got).items()} == where
        assert torch.equal(got.pool.alive, eager.pool.alive)
    finally:
        graphs.release()
    _assert_updates_close(got, eager, start)


@pytest.mark.cuda
def test_cuda_replay_counts_its_captured_launches(cuda_device):
    """A capture counts no launch, a replay adds what the graph captured,
    and a block of one replays the held graph."""
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr

    state, args = _graph_setup(cuda_device, seed=12)
    rig = _graph_cameras(cuda_device, 3, seed=22)
    graphs.release()
    try:
        captured = tk.compositor_launches(tk.captured)
        state, _ = tr.train_steps_scan_multicam(state, [rig], 3, "fine",
                                                *args)
        g = graphs.current()
        assert tk.compositor_launches(g.captured) == (3, 3)
        assert [a - b for a, b in zip(tk.compositor_launches(tk.captured),
                                      captured)] == [3, 3]
        for _ in range(2):
            before = tk.compositor_launches()
            state, _ = tr.train_steps_scan_multicam(state, [rig], 3, "fine",
                                                    *args)
            assert graphs.current() is g
            assert (tk.launches["composite_fwd"] - before[0],
                    tk.launches["composite_bwd"] - before[1]) == (3, 3)
        assert g.replays == 3
    finally:
        graphs.release()


@pytest.mark.cuda
def test_cuda_captures_share_one_side_stream(cuda_device):
    """Every capture on a device runs on one side stream, so cuBLAS keeps
    one workspace for them all: a second capture of another key (a rig
    after a single camera) reuses the first's stream."""
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr

    state, args = _graph_setup(cuda_device, seed=14)
    cams = _graph_cameras(cuda_device, 3, seed=24)
    graphs.release()
    streams = []
    orig = graphs.side_stream

    def recording(dev):
        streams.append(orig(dev))
        return streams[-1]
    graphs.side_stream = recording
    try:
        state, _ = tr.train_steps_scan(state, cams[:1], "fine", *args)
        state, _ = tr.train_steps_scan_multicam(state, [cams], 3, "fine",
                                                *args)
    finally:
        graphs.side_stream = orig
        graphs.release()
    assert len(streams) == 2 and streams[0] == streams[1]
    assert streams[0] == graphs.side_stream(cuda_device)
    assert streams[0] != torch.cuda.current_stream(cuda_device)


@pytest.mark.cuda
def test_cuda_eager_step_never_waits_for_the_host(cuda_device):
    """One eager step, single and rig, under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync, so the
    step can be captured."""
    from s3gaussian_tpu_torch.train import trainer as tr

    state, args = _graph_setup(cuda_device, seed=13)
    cams = _graph_cameras(cuda_device, 4, seed=23)
    state, _ = tr.train_step(state, cams[0], "fine", *args)   # lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = tr.train_step(state, cams[1], "fine", *args)
        state, _ = tr.train_step_multicam(state, cams[1:], "fine", *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_parallel_block_over_gloo_raises(cuda_device, tmp_path):
    """A data-parallel block on the card captures its all-reduces, which
    gloo cannot be captured into: over gloo it raises, naming NCCL and
    ``--steps_per_dispatch 1``, before it captures anything."""
    import torch.distributed as dist

    from s3gaussian_tpu_torch.parallel import data_parallel as dp
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost
    from s3gaussian_tpu_torch.train import graphs

    state, args = _graph_setup(cuda_device, seed=14)
    cams = _graph_cameras(cuda_device, 2, seed=24)
    graphs.release()
    assert init_multihost("file://" + str(tmp_path / "store"), 1, 0,
                          backend="gloo", device="cuda") == (0, 1)
    try:
        with pytest.raises(RuntimeError, match="NCCL.*--steps_per_dispatch 1"):
            dp.parallel_train_steps_scan(state, cams, "fine", *args)
        assert graphs.current() is None
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the pair stream's and the field's backward: no atomics, the same bits
# on repeat
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rig", [False, True])
def test_cuda_eager_step_repeats_bit_for_bit(cuda_device, rig):
    """Two eager steps from one state (single camera, or a rig of 3 with
    two-class emission): the same loss, parameters, moments and
    statistics, bit for bit."""
    import dataclasses

    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors

    state, args = _graph_setup(cuda_device, seed=14)
    cams = _graph_cameras(cuda_device, 3, seed=24)
    if rig:
        args = args[:4] + (dataclasses.replace(args[4], big_budget=256),) \
            + args[5:]
    runs = []
    for _ in range(2):
        st, aux = (tr.train_step_multicam(_copy(state), cams, "fine", *args)
                   if rig else tr.train_step(_copy(state), cams[0], "fine",
                                             *args))
        runs.append((state_tensors(st), aux["metrics"]["loss"]))
    (a, la), (b, lb) = runs
    assert torch.equal(la, lb)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


# --------------------------------------------------------------------------
# the sweep's renders as CUDA graphs
# --------------------------------------------------------------------------

def _sweep_setup(dev, n_rigs=2):
    """The graph state's pool and field, and ``n_rigs`` rigs of 3 cameras
    at one time each, with images and dynamic masks."""
    import dataclasses

    state, args = _graph_setup(dev, seed=15)
    cams = _graph_cameras(dev, 3 * n_rigs, seed=25)
    out = []
    for i, c in enumerate(cams):
        mask = np.zeros((H, W), bool)
        if i != 1:                          # one view's mask stays empty
            mask[10:30, 20:60] = True
        out.append(dataclasses.replace(
            c, time=cams[3 * (i // 3)].time.clone(),
            dynamic_mask=torch.from_numpy(mask).to(dev)))
    return state, args, out


@pytest.mark.cuda
def test_cuda_sweep_renders_never_wait_for_the_host(cuda_device):
    """One eager render of each kind the sweep captures: a rig with the
    decomposition and the metrics, a camera with flow colours, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from s3gaussian_tpu_torch.eval import video

    state, args, cams = _sweep_setup(cuda_device, 1)
    sh, hp, opt, pipe, cfg, _, bg = args
    rig_fn = video._sweep_render(state.pool, state.deform, pipe, bg,
                                 state.aabb, sh, "fine", cfg, True, True,
                                 True, True, False)
    flow_fn = video._sweep_render(state.pool, state.deform, pipe, bg,
                                  state.aabb, sh, "fine", cfg, False, False,
                                  False, False, False)
    rig = [video._slim(c, True) for c in cams]
    one = [video._slim(cams[0], False)]
    colors = torch.rand((state.pool.capacity, 3), device=cuda_device)
    with torch.no_grad():
        rig_fn(rig)
        flow_fn(one, override_color=colors)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rig_fn(rig)
            flow_fn(one, override_color=colors)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_replayed_sweep_matches_direct_renders(cuda_device):
    """``render_pixels`` on the card (replays of a rig graph and a flow
    graph) against ``render_multicam`` and ``render`` called directly:
    frames within 5e-4 of the clipped render beyond the uint8 step, flow
    frames included; depth atol 5e-4 rtol 1e-4; per-view metrics within
    1e-5; one capture a kind, the graph released at the end, the
    launches a replay counts."""
    from s3gaussian_tpu_torch.eval import video
    from s3gaussian_tpu_torch.eval.visualization import scene_flow_to_rgb
    from s3gaussian_tpu_torch.render.renderer import render, render_multicam
    from s3gaussian_tpu_torch.train import graphs

    state, args, cams = _sweep_setup(cuda_device, 2)
    sh, hp, opt, pipe, cfg, _, bg = args
    kw = dict(pool=state.pool, deform=state.deform, pipe=pipe, bg=bg,
              aabb=state.aabb)
    stats = {}
    graphs.release()
    before = tk.compositor_launches()
    frames = video.render_pixels(cams, active_sh_degree=sh, stage="fine",
                                 cfg=cfg, stats=stats, **kw)
    assert graphs.current() is None
    assert [(w, n) for w, _, _, n in stats["captures"]] == [
        ("rig", (9, 0)), ("flow", (1, 0))]
    assert stats["replays"] == 2 + 2 * len(cams)
    # replays count what their graph captured, the warm-ups once more
    assert (tk.launches["composite_fwd"] - before[0],
            tk.launches["composite_bwd"] - before[1]) == (
        2 * 9 + 2 * len(cams) + 10, 0)

    def close(frame, img):
        want = torch.clamp(img, 0, 1).permute(1, 2, 0).double().cpu().numpy()
        assert np.abs(frame - want).max() <= 0.5 / 255 + 5e-4

    pv = frames["metrics_per_view"]
    dx, masked = [], {"masked_psnr": [], "masked_ssim": []}
    with torch.no_grad():
        for r in range(2):
            rig = cams[3 * r:3 * r + 3]
            pkg = render_multicam(rig, state.pool, state.deform, pipe, bg,
                                  state.aabb, sh, stage="fine",
                                  return_decomposition=True, cfg=cfg)
            for b, cam in enumerate(rig):
                i = 3 * r + b
                close(frames["rgbs"][i], pkg["render"][b])
                close(frames["dynamic_rgbs"][i], pkg["render_d"][b])
                close(frames["static_rgbs"][i], pkg["render_s"][b])
                d = pkg["depth"][b].cpu().numpy()
                np.testing.assert_allclose(frames["depths"][i], d, atol=5e-4,
                                           rtol=1e-4)
                vals = video.view_metrics(pkg["render"][b], cam)
                for k in ("psnr", "ssim"):
                    assert abs(pv[k][i] - vals[k]) <= 1e-5, k
                for k in masked:
                    if k in vals:
                        masked[k].append(vals[k])
                dx.append(pkg["dx"])
        for k, v in masked.items():
            np.testing.assert_allclose(pv[k], v, rtol=0, atol=1e-5)
        assert len(masked["masked_psnr"]) == len(cams) - 1
        n = len(cams)
        for i, cam in enumerate(cams):
            for key, j in (("forward_flows", min(i + 9, n - 1)),
                           ("backward_flows", max(i - 9, 0))):
                colors = scene_flow_to_rgb(dx[j] - dx[i], flow_max_radius=2.0)
                img = render(cam, state.pool, state.deform, pipe, bg,
                             state.aabb, sh, stage="fine",
                             override_color=colors, cfg=cfg)["render"]
                close(frames[key][i], img)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 32, 64, 100, 128])
@pytest.mark.parametrize("with_perm", [False, True])
def test_cuda_segment_sum_matches_plain(cuda_device, d, with_perm):
    """The segment-sum kernel against its plain version on the card:
    ranges of 0 to 40 rows (empty ones included), read through a
    permutation or in place; max abs error within 1e-6·max|plain|, the
    same bits on repeat, one launch counted a call."""
    from s3gaussian_tpu_torch.ops import segsum

    rng = np.random.default_rng(d)
    k = 5000
    vals = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(
        cuda_device)
    perm = (torch.from_numpy(rng.permutation(k)).to(cuda_device)
            if with_perm else None)
    lens = rng.integers(0, 41, 400)
    offs = np.concatenate([[0], np.cumsum(lens)])
    offs = torch.from_numpy(np.minimum(offs, k)).to(cuda_device)
    before = tk.launches["segment_sum"]
    got = segsum.sum_ranges(vals, perm, offs)
    again = segsum.sum_ranges(vals, perm, offs)
    assert tk.launches["segment_sum"] - before == 2
    want = segsum.ranges_torch(vals, perm, offs)
    assert got.shape == (400, d) and torch.equal(got, again)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
