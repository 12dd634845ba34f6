# Frozen copy of s3gaussian_tpu_torch/ops/project.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Per-Gaussian screen-space preprocessing (port of
``s3gaussian_tpu/ops/project.py``): frustum cull, EWA projection of the
3D covariance to a 2D conic, screen radius, tile rectangle, view depth.

Conventions are the reference's: row-vector transforms (``p @ view``),
NDC->pixel ``((ndc+1)*S - 1)/2``, +0.3 px low-pass on the 2D covariance,
radius = ceil(3·sqrt(max eigenvalue)), near-plane cull at z <= 0.2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.frozen.ref.ops.sh import eval_sh, eval_sh_dynamic


class ProjectedGaussians(NamedTuple):
    xy: torch.Tensor          # [N,2] pixel-space center
    depth: torch.Tensor       # [N]   view-space z
    conic: torch.Tensor       # [N,3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor      # [N]   int32 screen radius, 0 = culled
    tiles_rect: torch.Tensor  # [N,4] int32 (x0, y0, x1, y1) tile rect, half-open
    visible: torch.Tensor     # [N]   bool


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """World covariance R diag(s²) Rᵀ from activated scales and (possibly
    unnormalized) quaternions, packed [N, 6] = (xx, xy, xz, yy, yz, zz)."""
    q = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scales * scale_modifier
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], -1)


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    view: torch.Tensor,
    proj: torch.Tensor,
    tanfovx: float | torch.Tensor,
    tanfovy: float | torch.Tensor,
    width: int,
    height: int,
    tile_x: int = 16,
    tile_y: int = 16,
    mean2d_tap: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    radius_margin: float = 0.0,
    opacities: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project Gaussians into screen space.

    ``mean2d_tap`` ([N,2] zeros) is added to the NDC centre, so its
    gradient is the NDC screen gradient the reference accumulates for the
    densification statistics (train.py:435-437).

    ``opacities`` ([N] or [N,1], activated) enables the tight rect: the
    tile rectangle becomes the bbox of the alpha-cutoff ellipse
    q <= Q = 2·ln(255·opac), outside which the compositor masks every
    contribution anyway.  Visibility keeps the reference's circumscribed
    3σ circle-rect predicate (it gates densification statistics)."""
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    p_hom4 = torch.cat([means3d, torch.ones_like(means3d[..., :1])], -1)
    p_view = p_hom4 @ view
    depth = p_view[..., 2]

    p_hom = p_hom4 @ proj
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    ndc_xy = p_hom[..., :2] * p_w[..., None]
    if mean2d_tap is not None:
        ndc_xy = ndc_xy + mean2d_tap
    # the image size as Python scalars: a tensor made from host values
    # here would be a host-to-device copy in every step
    xy = (torch.stack([(ndc_xy[..., 0] + 1.0) * width,
                       (ndc_xy[..., 1] + 1.0) * height], -1) - 1.0) * 0.5

    # EWA: cov2d = J W Σ Wᵀ Jᵀ, scalarized.  view[:3,:3] is R_w2c^T.
    Rw2c = view[:3, :3].T
    # tz clamped away from zero: culled rows (z <= 0.2, incl. dead pool
    # slots at the origin) would otherwise give inf Jacobians
    tz = torch.where(depth > 0.2, depth, torch.ones_like(depth))
    tx = torch.clamp(p_view[..., 0] / tz, -1.3 * tanfovx, 1.3 * tanfovx) * tz
    ty = torch.clamp(p_view[..., 1] / tz, -1.3 * tanfovy, 1.3 * tanfovy) * tz

    inv_z = 1.0 / tz
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z * inv_z
    t0 = [j00 * Rw2c[0, k] + j02 * Rw2c[2, k] for k in range(3)]
    t1 = [j11 * Rw2c[1, k] + j12 * Rw2c[2, k] for k in range(3)]

    cxx, cxy, cxz, cyy, cyz, czz = cov3d.unbind(-1)

    def quad(u, v):
        return (u[0] * (cxx * v[0] + cxy * v[1] + cxz * v[2])
                + u[1] * (cxy * v[0] + cyy * v[1] + cyz * v[2])
                + u[2] * (cxz * v[0] + cyz * v[1] + czz * v[2]))

    a = quad(t0, t0) + 0.3
    c = quad(t1, t1) + 0.3
    b = quad(t0, t1)

    det = a * c - b * b
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-12)))

    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    xy_ng = xy.detach()
    r_ng = radius_f.detach()
    if opacities is None:
        rx = ry = r_ng
    else:
        op = opacities.detach().reshape(-1)
        q_cut = torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-9) * 255.0),
                            min=0.0)
        rx = torch.ceil(torch.sqrt(q_cut * torch.clamp(a.detach(), min=0.0)))
        ry = torch.ceil(torch.sqrt(q_cut * torch.clamp(c.detach(), min=0.0)))
    rx = rx + radius_margin
    ry = ry + radius_margin

    def tile_rect(hx, hy):
        def cell(v, n, size):
            return torch.clamp(torch.floor(v / size), 0, n).to(torch.int32)
        return (cell(xy_ng[..., 0] - hx, grid_x, tile_x),
                cell(xy_ng[..., 1] - hy, grid_y, tile_y),
                cell(xy_ng[..., 0] + hx + tile_x - 1, grid_x, tile_x),
                cell(xy_ng[..., 1] + hy + tile_y - 1, grid_y, tile_y))

    x0, y0, x1, y1 = tile_rect(rx, ry)
    if opacities is None:
        vx0, vy0, vx1, vy1 = x0, y0, x1, y1
    else:
        r_c = r_ng + radius_margin
        vx0, vy0, vx1, vy1 = tile_rect(r_c, r_c)
    visible = (depth > 0.2) & (det > 0.0) & ((vx1 - vx0) * (vy1 - vy0) > 0)
    if alive is not None:
        visible = visible & alive

    radius = torch.where(visible, r_ng, torch.zeros_like(r_ng)).to(torch.int32)
    return ProjectedGaussians(xy=xy, depth=depth, conic=conic, radius=radius,
                              tiles_rect=torch.stack([x0, y0, x1, y1], -1),
                              visible=visible)


def sh_to_color(shs: torch.Tensor, means3d: torch.Tensor,
                campos: torch.Tensor,
                active_degree: int | torch.Tensor) -> torch.Tensor:
    """SH [N, K, 3] -> clamped RGB along the view direction
    (``clamp_min(eval_sh(deg, sh, dir) + 0.5, 0)``).  A Python degree
    evaluates its bands alone; a 0-d tensor degree (the captured train
    step's) band-masks a full evaluation (``eval_sh_dynamic``)."""
    dirs = means3d - campos[None, :]
    # clamped norm: dead pool slots can sit exactly at the camera origin
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-8)
    sh_view = shs.transpose(-1, -2)
    if isinstance(active_degree, torch.Tensor):
        rgb = eval_sh_dynamic(active_degree, sh_view, dirs,
                              max_deg=int(round(shs.shape[-2] ** 0.5)) - 1)
    else:
        rgb = eval_sh(active_degree, sh_view, dirs)
    return torch.clamp(rgb + 0.5, min=0.0)
