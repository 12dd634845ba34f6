"""Evaluation metrics (port of ``s3gaussian_tpu/eval/metrics.py``).

  * PSNR, 20·log10(1/√mse), and its dynamic-mask variant;
  * skimage's default SSIM (uniform 7×7 window, sample covariance with
    the N/(N-1) correction, ``win//2`` cropped at each edge), and the
    masked variant, which averages the uncropped map under the mask;
  * LPIPS when weights are present (``eval/lpips.py``), else None.

Images are [H, W, 3] tensors in [0, 1]; every function computes in
float64 on their device and returns a 0-d float64 tensor, so the sweep
computes its metrics from the float32 render without leaving the card.
SSIM's variances ``E[x²] − E[x]²`` cancel catastrophically: in float32
a flat region's SSIM is off by a few 1e-5 (masked SSIM of a 640×960
sweep frame on the H100: 1.9e-5 from float64), and a TF32 product would
make them noise.  The 7×7 filter is ``avg_pool2d`` with zero padding,
which runs on no tensor-core path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from s3gaussian_tpu_torch.eval.lpips import lpips


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((_f64(pred) - _f64(gt)) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def masked_psnr(pred: torch.Tensor, gt: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """PSNR over the pixels of ``mask`` [H, W] bool (video_utils.py:223-231
    of the reference)."""
    m = mask[..., None]
    n = torch.clamp(m.sum() * 3, min=1)
    sq = (_f64(pred) - _f64(gt)) ** 2
    mse = torch.where(m, sq, 0.0).sum() / n
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """The win×win mean of x [C, H, W] at every pixel, zeros outside: the
    ``convolve2d(x, ones/win², mode="same")`` of the JAX package."""
    return F.avg_pool2d(x[None], win, stride=1, padding=win // 2,
                        count_include_pad=True)[0]


def _ssim_map(pred: torch.Tensor, gt: torch.Tensor, win: int,
              data_range: float) -> torch.Tensor:
    """Per-channel SSIM map [C, H, W] of [H, W, C] images."""
    x = _f64(pred).permute(2, 0, 1)
    y = _f64(gt).permute(2, 0, 1)
    n = win * win
    cov_norm = n / (n - 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ux = _uniform_filter(x, win)
    uy = _uniform_filter(y, win)
    vx = cov_norm * (_uniform_filter(x * x, win) - ux * ux)
    vy = cov_norm * (_uniform_filter(y * y, win) - uy * uy)
    vxy = cov_norm * (_uniform_filter(x * y, win) - ux * uy)
    return (((2 * ux * uy + c1) * (2 * vxy + c2))
            / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))


def ssim_skimage(pred: torch.Tensor, gt: torch.Tensor, win: int = 7,
                 data_range: float = 1.0) -> torch.Tensor:
    """``skimage.metrics.structural_similarity`` with default settings,
    channel-averaged, over the region ``win//2`` inside each edge."""
    if pred.dim() == 2:
        pred, gt = pred[..., None], gt[..., None]
    pad = win // 2
    return _ssim_map(pred, gt, win, data_range)[:, pad:-pad, pad:-pad].mean()


def masked_ssim(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                win: int = 7) -> torch.Tensor:
    """The channel-averaged SSIM map, edges included, averaged over the
    pixels of ``mask`` (video_utils.py:233-241 of the reference)."""
    smap = _ssim_map(pred, gt, win, 1.0).mean(0)
    return torch.where(mask, smap, 0.0).sum() / torch.clamp(mask.sum(), min=1)


def lpips_or_none(pred: torch.Tensor, gt: torch.Tensor,
                  net: str = "alex") -> Optional[float]:
    """LPIPS if weights are available locally (``S3G_LPIPS_WEIGHTS``), else
    None."""
    try:
        return float(lpips(pred, gt, net=net))
    except FileNotFoundError:
        return None
