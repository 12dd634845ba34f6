"""Per-Gaussian screen-space preprocessing (port of
``s3gaussian_tpu/ops/project.py``): frustum cull, EWA projection of the
3D covariance to a 2D conic, screen radius, tile rectangle, view depth.

Conventions are the reference's: row-vector transforms (``p @ view``),
NDC->pixel ``((ndc+1)*S - 1)/2``, +0.3 px low-pass on the 2D covariance,
radius = ceil(3·sqrt(max eigenvalue)), near-plane cull at z <= 0.2.

On the card ``project`` (``build_cov3d`` + ``project_gaussians``) and
``sh_to_color`` run the CUDA kernels of ``csrc/project.cu``, forward and
backward (``_Project``, ``_ShColor``), which repeat the plain code's
arithmetic as PyTorch runs it on the card (its ``@`` and
``torch.linalg.norm`` included), so tile rects, radii and visibility
are equal there; CPU tensors take the plain code below.  A CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.sh import eval_sh, eval_sh_dynamic


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


def sh_to_color_plain(shs: torch.Tensor, means3d: torch.Tensor,
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


# --- the CUDA kernels of csrc/project.cu

SH_COEFFS = (1, 4, 9, 16)     # the coefficient counts of degrees 0-3


def _fov(tan: float | torch.Tensor, size: int):
    """A tan(fov/2) as the kernels take it: (0-d tensor or None, focal,
    clamp bound); a Python float's focal and bound computed here in
    double, as the plain path computes them."""
    if isinstance(tan, torch.Tensor):
        return tan, 0.0, 0.0
    return None, size / (2.0 * tan), 1.3 * tan


def _check_float(name: str, t, shape, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, means3d on {dev}")


def _check_camera(name: str, t) -> None:
    if isinstance(t, torch.Tensor) and t.requires_grad \
            and torch.is_grad_enabled():
        raise ValueError(f"the projection kernels take no gradient to the "
                         f"camera: {name} requires grad")


def check_project(means3d: torch.Tensor, scales: torch.Tensor,
                  rotations: torch.Tensor, view: torch.Tensor,
                  proj: torch.Tensor, tanfovx: float | torch.Tensor,
                  tanfovy: float | torch.Tensor,
                  mean2d_tap: Optional[torch.Tensor] = None,
                  alive: Optional[torch.Tensor] = None,
                  opacities: Optional[torch.Tensor] = None) -> None:
    """Raises (ValueError, TypeError) on what the projection kernels do not
    take: means3d [N, 3], scales [N, 3] (activated), rotations [N, 4], view
    and proj [4, 4], mean2d_tap [N, 2], opacities [N] or [N, 1], all
    float32 on one device; alive [N] bool; tan(fov/2) a Python number or a
    0-d float32 tensor there; no camera tensor that requires grad."""
    if means3d.dim() != 2 or means3d.shape[1] != 3:
        raise ValueError(f"means3d must be [N, 3], got "
                         f"{tuple(means3d.shape)}")
    n, dev = means3d.shape[0], means3d.device
    _check_float("means3d", means3d, (n, 3), dev)
    _check_float("scales", scales, (n, 3), dev)
    _check_float("rotations", rotations, (n, 4), dev)
    _check_float("view", view, (4, 4), dev)
    _check_float("proj", proj, (4, 4), dev)
    for name, tan in (("tanfovx", tanfovx), ("tanfovy", tanfovy)):
        if isinstance(tan, torch.Tensor):
            _check_float(name, tan, (), dev)
        elif not isinstance(tan, (int, float)):
            raise TypeError(f"{name} must be a number or a 0-d tensor, got "
                            f"{type(tan).__name__}")
        _check_camera(name, tan)
    _check_camera("view", view)
    _check_camera("proj", proj)
    if mean2d_tap is not None:
        _check_float("mean2d_tap", mean2d_tap, (n, 2), dev)
    if opacities is not None:
        _check_float("opacities", opacities.reshape(-1), (n,), dev)
    if alive is not None:
        if tuple(alive.shape) != (n,) or alive.dtype != torch.bool:
            raise ValueError(f"alive must be [{n}] bool, got "
                             f"{tuple(alive.shape)} {alive.dtype}")
        if alive.device != dev:
            raise ValueError(f"alive on {alive.device}, means3d on {dev}")


def check_sh(shs: torch.Tensor, means3d: torch.Tensor, campos: torch.Tensor,
             active_degree: int | torch.Tensor) -> None:
    """Raises (ValueError, TypeError) on what the SH kernels do not take:
    shs [N, K, 3] with K of SH_COEFFS, means3d [N, 3], campos [3], all
    float32 on one device; a degree that is a Python int of 0 to the
    coefficients' degree or a 0-d integer tensor there; no camera centre
    that requires grad."""
    if shs.dim() != 3 or shs.shape[1] not in SH_COEFFS or shs.shape[2] != 3:
        raise ValueError(f"shs must be [N, K, 3] with K of {SH_COEFFS}, got "
                         f"{tuple(shs.shape)}")
    n, dev = shs.shape[0], shs.device
    _check_float("shs", shs, shs.shape, dev)
    if means3d.device != dev:
        raise ValueError(f"means3d on {means3d.device}, shs on {dev}")
    _check_float("means3d", means3d, (n, 3), dev)
    if campos.device != dev:
        raise ValueError(f"campos on {campos.device}, shs on {dev}")
    _check_float("campos", campos, (3,), dev)
    _check_camera("campos", campos)
    max_deg = SH_COEFFS.index(shs.shape[1])
    if isinstance(active_degree, torch.Tensor):
        if active_degree.dim() != 0 or active_degree.is_floating_point() \
                or active_degree.is_complex() \
                or active_degree.dtype == torch.bool:
            raise TypeError(f"a tensor degree must be a 0-d integer tensor, "
                            f"got {tuple(active_degree.shape)} "
                            f"{active_degree.dtype}")
        if active_degree.device != dev:
            raise ValueError(f"the degree on {active_degree.device}, shs on "
                             f"{dev}")
    elif not 0 <= active_degree <= max_deg:
        raise ValueError(f"SH degree {active_degree} not in [0, {max_deg}] "
                         f"for {shs.shape[1]} coefficients")


def project_fwd(means3d, scales, rotations, tap, view, proj, tanfovx,
                tanfovy, alive, opacities, dims,
                radius_margin) -> ProjectedGaussians:
    """Launch the projection's forward kernel on checked, contiguous
    inputs (opacities [N] or None); ``dims`` = (width, height, tile_x,
    tile_y)."""
    n, dev = means3d.shape[0], means3d.device
    width, height, tile_x, tile_y = dims
    f32 = dict(dtype=torch.float32, device=dev)
    out = ProjectedGaussians(
        xy=torch.empty((n, 2), **f32), depth=torch.empty((n,), **f32),
        conic=torch.empty((n, 3), **f32),
        radius=torch.empty((n,), dtype=torch.int32, device=dev),
        tiles_rect=torch.empty((n, 4), dtype=torch.int32, device=dev),
        visible=torch.empty((n,), dtype=torch.bool, device=dev))
    tx, fx, lx = _fov(tanfovx, width)
    ty, fy, ly = _fov(tanfovy, height)
    lib = tk._load("project")
    tk.launch("project_fwd", lib.project_fwd, means3d, scales, rotations,
              tap, alive, opacities, view, proj, tx, ty, fx,
              fy, lx, ly, n, width, height, tile_x, tile_y,
              float(radius_margin), *out)
    return out


def project_bwd(means3d, scales, rotations, view, proj, tanfovx, tanfovy,
                dims, g_xy, g_depth, g_conic,
                need=(True, True, True, False)):
    """Launch the projection's backward kernel: the cotangents of xy, depth
    and conic (each None where it has none) -> (d_means3d, d_scales,
    d_rotations, d_tap), each None where ``need`` says so."""
    n, dev = means3d.shape[0], means3d.device
    width, height = dims[:2]
    outs = [torch.empty((n, k), dtype=torch.float32, device=dev)
            if want else None for want, k in zip(need, (3, 3, 4, 2))]
    tx, fx, lx = _fov(tanfovx, width)
    ty, fy, ly = _fov(tanfovy, height)
    lib = tk._load("project")
    tk.launch("project_bwd", lib.project_bwd, means3d, scales, rotations,
              view, proj, tx, ty, fx, fy, lx, ly, n, width, height,
              *(None if g is None else g.contiguous()
                for g in (g_xy, g_depth, g_conic)),
              *outs)
    return tuple(outs)


class _Project(torch.autograd.Function):
    """``project_fwd`` with ``project_bwd`` as its backward.  Saves only its
    inputs (the backward recomputes the rest); the radius, rects and
    visibility are not differentiable."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, tap, view, proj, tanfovx,
                tanfovy, alive, opacities, dims, radius_margin):
        out = project_fwd(means3d, scales, rotations, tap, view, proj,
                          tanfovx, tanfovy, alive, opacities, dims,
                          radius_margin)
        fov = [t if isinstance(t, torch.Tensor) else None
               for t in (tanfovx, tanfovy)]
        ctx.save_for_backward(means3d, scales, rotations, view, proj, *fov)
        ctx.fov = [None if isinstance(t, torch.Tensor) else t
                   for t in (tanfovx, tanfovy)]
        ctx.dims = dims
        ctx.mark_non_differentiable(out.radius, out.tiles_rect, out.visible)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_xy, g_depth, g_conic, *_):
        means3d, scales, rotations, view, proj, *fov = ctx.saved_tensors
        tanfovx, tanfovy = (t if t is not None else f
                            for t, f in zip(fov, ctx.fov))
        need = ctx.needs_input_grad[:4]
        if (g_xy is None and g_depth is None and g_conic is None) \
                or not any(need):
            return (None,) * 12
        grads = project_bwd(means3d, scales, rotations, view, proj, tanfovx,
                            tanfovy, ctx.dims, g_xy, g_depth, g_conic, need)
        return (*grads, *(None,) * 8)


def project(means3d: torch.Tensor, scales: torch.Tensor,
            rotations: torch.Tensor, view: torch.Tensor, proj: torch.Tensor,
            tanfovx: float | torch.Tensor, tanfovy: float | torch.Tensor,
            width: int, height: int, tile_x: int = 16, tile_y: int = 16,
            mean2d_tap: Optional[torch.Tensor] = None,
            alive: Optional[torch.Tensor] = None,
            radius_margin: float = 0.0,
            opacities: Optional[torch.Tensor] = None) -> ProjectedGaussians:
    """``project_gaussians`` of ``build_cov3d(scales, rotations)``
    (scales activated, rotations as given: normalised here): on CPU tensors that plain code, on CUDA tensors the kernels of
    ``csrc/project.cu`` (``check_project`` says what they take), the same
    rects, radii and visibility, differentiable to means3d, scales,
    rotations and mean2d_tap."""
    if means3d.device.type == "cpu":
        return project_gaussians(
            means3d, build_cov3d(scales, rotations), view,
            proj, tanfovx, tanfovy, width, height, tile_x=tile_x,
            tile_y=tile_y, mean2d_tap=mean2d_tap, alive=alive,
            radius_margin=radius_margin, opacities=opacities)
    if means3d.device.type != "cuda":
        raise ValueError(f"the projection runs on CPU or CUDA tensors, not "
                         f"{means3d.device}")
    check_project(means3d, scales, rotations, view, proj, tanfovx, tanfovy,
                  mean2d_tap, alive, opacities)
    op = (None if opacities is None
          else opacities.detach().reshape(-1).contiguous())
    return ProjectedGaussians(*_Project.apply(
        means3d.contiguous(), scales.contiguous(), tk.aligned(rotations),
        None if mean2d_tap is None else mean2d_tap.contiguous(),
        view.contiguous(), proj.contiguous(), tanfovx, tanfovy,
        None if alive is None else alive.contiguous(), op,
        (width, height, tile_x, tile_y), radius_margin))


def sh_fwd(shs, means3d, campos, degree) -> torch.Tensor:
    """Launch the SH colour's forward kernel on checked inputs (shs
    16-byte aligned, a tensor degree int32) -> [N, 3]."""
    n = shs.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=shs.device)
    tensor = isinstance(degree, torch.Tensor)
    lib = tk._load("project")
    tk.launch("sh_fwd", lib.sh_fwd, shs, shs.shape[1], means3d, campos, n,
              0 if tensor else int(degree), degree if tensor else None, out)
    return out


def sh_bwd(shs, means3d, campos, degree, g, want_means=True):
    """Launch the SH colour's backward kernel: the colours' cotangent g
    [N, 3] -> (d_shs [N, K, 3], d_means3d [N, 3] or None)."""
    n = shs.shape[0]
    d_shs = torch.empty_like(shs)
    d_means = (torch.empty((n, 3), dtype=torch.float32, device=shs.device)
               if want_means else None)
    tensor = isinstance(degree, torch.Tensor)
    lib = tk._load("project")
    tk.launch("sh_bwd", lib.sh_bwd, shs, shs.shape[1], means3d, campos, n,
              0 if tensor else int(degree), degree if tensor else None,
              g.contiguous(), d_shs, d_means)
    return d_shs, d_means


class _ShColor(torch.autograd.Function):
    """``sh_fwd`` with ``sh_bwd`` as its backward; saves only its inputs."""

    @staticmethod
    def forward(ctx, shs, means3d, campos, degree):
        out = sh_fwd(shs, means3d, campos, degree)
        tensor = isinstance(degree, torch.Tensor)
        ctx.save_for_backward(shs, means3d, campos,
                              degree if tensor else None)
        ctx.degree = None if tensor else degree
        return out

    @staticmethod
    def backward(ctx, g):
        shs, means3d, campos, deg = ctx.saved_tensors
        d_shs, d_means = sh_bwd(shs, means3d, campos,
                                deg if deg is not None else ctx.degree, g,
                                ctx.needs_input_grad[1])
        return (d_shs if ctx.needs_input_grad[0] else None, d_means, None,
                None)


def sh_to_color(shs: torch.Tensor, means3d: torch.Tensor,
                campos: torch.Tensor,
                active_degree: int | torch.Tensor) -> torch.Tensor:
    """``sh_to_color_plain`` on CPU tensors; on CUDA tensors the SH kernels
    of ``csrc/project.cu`` (``check_sh`` says what they take), the colours
    to rounding, differentiable to shs and means3d."""
    if shs.device.type == "cpu":
        return sh_to_color_plain(shs, means3d, campos, active_degree)
    if shs.device.type != "cuda":
        raise ValueError(f"the SH colour runs on CPU or CUDA tensors, not "
                         f"{shs.device}")
    check_sh(shs, means3d, campos, active_degree)
    if isinstance(active_degree, torch.Tensor):
        active_degree = active_degree.to(torch.int32)
    return _ShColor.apply(tk.aligned(shs), means3d.contiguous(),
                          campos.contiguous(), active_degree)
