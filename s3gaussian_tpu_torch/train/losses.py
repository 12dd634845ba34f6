"""Training losses (port of ``s3gaussian_tpu/train/losses.py``).

Parity: the reference's ``utils/loss_utils.py`` — l1/l2, the 11×11
σ=1.5 windowed SSIM (:56-96) and the masked normalized depth loss
(:21-45).  The SSIM window is separable, so the blur is two depthwise
1-D convolutions with zero padding, which equals the 2-D same-padding
window exactly; ``device.configure_device`` keeps cuDNN out of TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def normalize_depth(d: torch.Tensor, max_depth: float = 80.0) -> torch.Tensor:
    return torch.clamp(d / max_depth, 0.0, 1.0)


def depth_loss(pred: torch.Tensor, gt: torch.Tensor, loss_type: str = "l2",
               max_depth: float = 80.0) -> torch.Tensor:
    """Mean error over the valid lidar returns, gt in (0.01, max_depth),
    both sides normalized by /max_depth."""
    valid = (gt > 0.01) & (gt < max_depth)
    p = normalize_depth(pred, max_depth)
    g = normalize_depth(gt, max_depth)
    if loss_type == "l1":
        err = torch.abs(p - g)
    elif loss_type == "l2":
        err = (p - g) ** 2
    elif loss_type == "smooth_l1":
        d = torch.abs(p - g)
        err = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    else:
        raise ValueError(loss_type)
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, err, 0.0).sum() / n


@functools.lru_cache(maxsize=None)
def _gauss1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_on(window_size: int, device: torch.device) -> torch.Tensor:
    """The 1-D window on ``device``, copied there once: a captured step
    may not copy from the host."""
    return torch.from_numpy(_gauss1d(window_size)).to(device)


def _blur(x: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Separable gaussian blur of [B, C, H, W], zero padded."""
    c = x.shape[1]
    g = _window_on(window_size, x.device)
    pad = window_size // 2
    x = F.conv2d(x, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(pad, 0), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                    padding=(0, pad), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """img [C,H,W] or [B,C,H,W] -> mean SSIM (depthwise gaussian window,
    same padding, C1 = 0.01², C2 = 0.03²)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1, mu2 = _blur(img1, window_size), _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1, window_size) - mu1_sq
    s2 = _blur(img2 * img2, window_size) - mu2_sq
    s12 = _blur(img1 * img2, window_size) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu1_mu2 + c1) * (2 * s12 + c2))
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return torch.mean(m)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """20·log10(1/√mse) (reference utils/image_utils.py:17-19)."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
