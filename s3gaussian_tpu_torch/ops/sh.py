"""Real spherical-harmonics evaluation, degrees 0-3 (port of
``s3gaussian_tpu/ops/sh.py``; PlenOctree constants of the reference's
``utils/sh_utils.py``): ``eval_sh`` at a Python degree, and
``eval_sh_dynamic`` at a degree held in a tensor."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., C, >=(deg+1)**2] channel-major coefficients, dirs [..., 3]
    unit directions -> [..., C]."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} not in [0, 3]")
    if sh.shape[-1] < (deg + 1) ** 2:
        raise ValueError(f"{sh.shape[-1]} coefficients < degree {deg}")
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2]
                  - C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4]
                      + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7]
                      + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


def eval_sh_dynamic(deg: torch.Tensor, sh: torch.Tensor, dirs: torch.Tensor,
                    max_deg: int = 3) -> torch.Tensor:
    """``eval_sh`` at a degree held in a tensor: the coefficients of the
    bands above ``deg`` are masked to zero before a full ``max_deg``
    evaluation, so one captured step serves every degree of a stage."""
    coeff = (max_deg + 1) ** 2
    bands = torch.arange(coeff, device=sh.device).float().sqrt().floor()
    mask = (bands <= deg).to(sh.dtype)
    return eval_sh(max_deg, sh[..., :coeff] * mask, dirs)


def RGB2SH(rgb):
    return (rgb - 0.5) / C0


def SH2RGB(sh):
    return sh * C0 + 0.5
