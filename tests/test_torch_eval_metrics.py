"""The port's evaluation metrics (``eval/metrics.py``) against the JAX
package's on the same numpy inputs: PSNR within 1e-4 dB, skimage-style
SSIM and masked SSIM within 1e-5, masked PSNR within 1e-4 dB.  The
inputs take in near-identical pairs (SSIM's variances cancel there),
smooth low-variance images, non-square odd sizes, and empty, full and
partial masks.  On flat regions, where float32 SSIM is off by a few
1e-5, the port's (computed in float64) matches a float64 reference
within 1e-9."""

import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from s3gaussian_tpu.eval import metrics as jm
from s3gaussian_tpu_torch.eval import metrics as tm
from torch_threads import one_torch_thread  # noqa: F401


def pair(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    gt = rng.random((h, w, 3))
    if kind == "random":
        pred = rng.random((h, w, 3))
    elif kind == "near":          # near-identical: the cancellation case
        pred = np.clip(gt + rng.normal(0, 1e-3, gt.shape), 0, 1)
    elif kind == "smooth":        # low variance: the variances are tiny
        yy, xx = np.mgrid[0:h, 0:w]
        gt = 0.5 + 0.02 * np.sin((xx + 0.5 * yy)[..., None] / 7.0
                                 + np.arange(3) / 3)
        pred = gt + rng.normal(0, 2e-3, gt.shape)
    elif kind == "identical":
        pred = gt.copy()
    return pred.astype(np.float32), gt.astype(np.float32)


def mask(kind, h, w, seed):
    if kind == "empty":
        return np.zeros((h, w), bool)
    if kind == "full":
        return np.ones((h, w), bool)
    return np.random.default_rng(seed).random((h, w)) < 0.3


CASES = [("random", 32, 32), ("near", 64, 96), ("smooth", 48, 40),
         ("identical", 16, 24), ("random", 37, 53), ("near", 31, 17)]


@pytest.mark.parametrize("kind,h,w", CASES)
def test_psnr_and_ssim_match_jax(kind, h, w):
    pred, gt = pair(kind, h, w, seed=h * w)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    if kind != "identical":          # an infinite psnr on both sides
        np.testing.assert_allclose(float(tm.psnr(tp, tg)),
                                   float(jm.psnr(pred, gt)), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(float(tm.ssim_skimage(tp, tg)),
                               jm.ssim_skimage(pred, gt), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,h,w", CASES)
@pytest.mark.parametrize("mkind", ["empty", "full", "partial"])
def test_masked_metrics_match_jax(kind, h, w, mkind):
    pred, gt = pair(kind, h, w, seed=h + w)
    m = mask(mkind, h, w, seed=h)
    tp, tg, tmk = torch.from_numpy(pred), torch.from_numpy(gt), \
        torch.from_numpy(m)
    np.testing.assert_allclose(float(tm.masked_psnr(tp, tg, tmk)),
                               float(jm.masked_psnr(pred, gt, m)), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(tm.masked_ssim(tp, tg, tmk)),
                               jm.masked_ssim(pred, gt, m), rtol=0,
                               atol=1e-5)


def test_ssim_of_a_single_channel_and_in_float64():
    pred, gt = pair("near", 40, 56, seed=5)
    want = jm.ssim_skimage(pred[..., 0], gt[..., 0])
    got = tm.ssim_skimage(torch.from_numpy(pred[..., 0]),
                          torch.from_numpy(gt[..., 0]))
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-5)
    d64 = tm.ssim_skimage(torch.from_numpy(pred).double(),
                          torch.from_numpy(gt).double())
    assert d64.dtype == torch.float64
    np.testing.assert_allclose(float(d64), jm.ssim_skimage(pred, gt),
                               rtol=0, atol=1e-5)


def ssim_map_f64(x, y, win=7):
    """skimage's SSIM map in float64 with scipy's "same" convolution."""
    k = np.ones((win, win)) / win ** 2

    def f(a):
        return convolve2d(a, k, mode="same")

    n = win * win
    cov = n / (n - 1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    maps = []
    for c in range(x.shape[-1]):
        a, b = x[..., c], y[..., c]
        ux, uy = f(a), f(b)
        vx = cov * (f(a * a) - ux * ux)
        vy = cov * (f(b * b) - uy * uy)
        vxy = cov * (f(a * b) - ux * uy)
        maps.append(((2 * ux * uy + c1) * (2 * vxy + c2))
                    / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return np.mean(maps, 0)


def test_ssim_on_flat_regions_is_exact():
    rng = np.random.default_rng(0)
    h, w = 96, 128
    xx = np.arange(w)[None, :, None]
    gt = np.clip(0.45 + 0.05 * np.sin(xx / 9.0 + np.arange(3))
                 + 0.01 * rng.normal(size=(h, w, 3)), 0, 1)
    gt[:30] = 0.6                               # a flat sky
    pred = np.clip(0.3 * gt + 0.02 * rng.normal(size=gt.shape), 0, 1)
    pred[:30] = 0.2
    pred, gt = pred.astype(np.float32), gt.astype(np.float32)
    mask = np.zeros((h, w), bool)
    mask[20:60, 30:100] = True
    smap = ssim_map_f64(pred.astype(np.float64), gt.astype(np.float64))
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    np.testing.assert_allclose(float(tm.ssim_skimage(tp, tg)),
                               smap[3:-3, 3:-3].mean(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        float(tm.masked_ssim(tp, tg, torch.from_numpy(mask))),
        smap[mask].mean(), rtol=0, atol=1e-9)
