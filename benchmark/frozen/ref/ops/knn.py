# Written for the plain reference after native/s3g_native.cpp::knn_mean_dist2
# and s3gaussian_tpu_torch/ops/knn.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec.
"""Mean squared distance of the 3 nearest neighbours, the initial
Gaussian size, in plain PyTorch on the reference's device.

The search is the one the program's native library makes: 30-bit Morton
codes of the points normalised to their bounding box (1,024 cells an
axis), a stable sort by code, and for each point the k best squared
distances among the window points on either side of it in that
order (fewer at the two ends), their mean in float32."""

from __future__ import annotations

import numpy as np
import torch


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def mean_knn_dist2(points: np.ndarray, k: int = 3, window: int = 32,
                   device: str | torch.device | None = None,
                   block: int = 1 << 18) -> np.ndarray:
    """points [n, 3] -> [n] float32 (numpy)."""
    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    p = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    n = p.shape[0]
    if n <= 1:
        return np.zeros(n, np.float32)
    lo = p.amin(0)
    span = torch.clamp(p.amax(0) - lo, min=1e-9)
    q = torch.clamp(((p - lo) / span * 1024.0).to(torch.int32), 0, 1023)
    q = q.to(torch.int64)
    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)
    order = torch.sort(code, stable=True).indices
    sp = p[order]
    kk = min(k, n - 1)
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    out_sorted = torch.empty(n, dtype=torch.float32, device=dev)
    for a in range(0, n, block):
        s = torch.arange(a, min(a + block, n), device=dev)
        t = s[:, None] + offs[None, :]
        ok = (t >= 0) & (t < n)
        q_ = sp[t.clamp(0, n - 1)]
        d = sp[s][:, None, :] - q_
        # in the native library's order: (dx*dx + dy*dy) + dz*dz
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        d2 = torch.where(ok, d2, torch.inf)
        best = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
        acc = best[:, 0]
        for j in range(1, kk):
            acc = acc + best[:, j]
        out_sorted[a:a + len(s)] = acc / kk
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted
    return out.cpu().numpy()
