"""LPIPS (port of ``s3gaussian_tpu/eval/lpips_jax.py``): AlexNet or VGG16
feature stacks with linear calibration heads.

Parity: ``lpipsPyTorch/`` of the reference, which builds on torchvision's
pretrained weights.  No weights are downloaded: set ``S3G_LPIPS_WEIGHTS``
to an ``.npz`` written by ``export_weights()`` (run once on a machine
with torchvision and the ``lpips`` package); without it ``lpips()``
raises FileNotFoundError and callers record the metric as None
(``eval/metrics.py::lpips_or_none``).

The graph mirrors lpipsPyTorch/modules/networks.py: feature taps after
each conv stage, unit normalisation along channels, squared difference,
1x1 linear head, spatial mean, sum over stages.  The convolutions run in
full float32 whatever the global TF32 flag says (``_ieee_f32_convs``).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from s3gaussian_tpu_torch.weights import lpips_weights_from_numpy

# ImageNet normalisation used by LPIPS (networks.py BaseNet)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def export_weights(path: str, net: str = "alex") -> None:  # pragma: no cover
    """Run on a machine with torch+torchvision+lpips to produce the npz."""
    import lpips as lpips_torch

    model = lpips_torch.LPIPS(net=net)
    arrs = {}
    feats = model.net
    for name, p in feats.named_parameters():
        arrs[f"net.{name}"] = p.detach().numpy()
    for i, lin in enumerate(model.lins):
        arrs[f"lin{i}.weight"] = lin.model[-1].weight.detach().numpy()
    np.savez(path, **arrs)


@functools.lru_cache(maxsize=4)
def _load(path: str, net: str, device: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as d:
        return lpips_weights_from_numpy(dict(d), device)


def load_weights(net: str, device: torch.device | str
                 ) -> Dict[str, torch.Tensor]:
    """The weights of ``S3G_LPIPS_WEIGHTS`` on ``device``, read once per
    file, net and device."""
    path = os.environ.get("S3G_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights unavailable: set S3G_LPIPS_WEIGHTS to an npz from "
            "eval/lpips.py:export_weights()")
    return _load(path, net, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _norm_on(device: str):
    """The input normalisation's shift and scale [1,3,1,1] on ``device``,
    copied there once: a captured render may not copy from the host."""
    return tuple(torch.tensor(v, device=device).reshape(1, 3, 1, 1)
                 for v in (_SHIFT, _SCALE))


def available(net: str, device: torch.device | str) -> bool:
    """True when ``S3G_LPIPS_WEIGHTS`` loads for ``net`` on ``device``."""
    try:
        load_weights(net, device)
    except FileNotFoundError:
        return False
    return True


@contextlib.contextmanager
def _ieee_f32_convs():
    """cuDNN runs float32 convolutions in TF32 (10 mantissa bits) when the
    global flag allows it; LPIPS needs them in full float32 (its parity
    budget is ±0.005)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(x, wts, name, stride=1, pad=0):
    return F.conv2d(x, wts[f"{name}.weight"], wts[f"{name}.bias"],
                    stride=stride, padding=pad)


def _alex_features(x, wts) -> List[torch.Tensor]:
    """torchvision alexnet.features with taps after each ReLU."""
    taps = []
    x = F.relu(_conv(x, wts, "net.slice1.0", stride=4, pad=2))
    taps.append(x)
    x = F.max_pool2d(x, 3, 2)
    x = F.relu(_conv(x, wts, "net.slice2.3", pad=2))
    taps.append(x)
    x = F.max_pool2d(x, 3, 2)
    x = F.relu(_conv(x, wts, "net.slice3.6", pad=1))
    taps.append(x)
    x = F.relu(_conv(x, wts, "net.slice4.8", pad=1))
    taps.append(x)
    x = F.relu(_conv(x, wts, "net.slice5.10", pad=1))
    taps.append(x)
    return taps


def _vgg_features(x, wts) -> List[torch.Tensor]:
    """torchvision vgg16.features with taps after relu1_2/2_2/3_3/4_3/5_3
    (lpipsPyTorch/modules/networks.py VGG slices)."""
    taps = []
    li = 0
    for block, n_convs in enumerate((2, 2, 3, 3, 3)):
        for _ in range(n_convs):
            x = F.relu(_conv(x, wts, f"net.slice{block + 1}.{li}", pad=1))
            li += 2  # conv + relu
        taps.append(x)
        if block < 4:
            x = F.max_pool2d(x, 2, 2)
            li += 1  # maxpool
    return taps


@torch.no_grad()
def lpips(pred: torch.Tensor, gt: torch.Tensor,
          net: str = "alex") -> torch.Tensor:
    """pred/gt: [H, W, 3] in [0, 1] on one device.  A 0-d float32 tensor
    there."""
    wts = load_weights(net, pred.device)
    shift, scale = _norm_on(str(pred.device))

    def prep(img):
        x = img.float().permute(2, 0, 1)[None] * 2 - 1
        return (x - shift) / scale

    feats = _alex_features if net == "alex" else _vgg_features
    with _ieee_f32_convs():
        fx = feats(prep(pred), wts)
        fy = feats(prep(gt), wts)
    total = torch.zeros((), device=pred.device)
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2
        w = wts[f"lin{i}.weight"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * w, dim=1))
    return total
