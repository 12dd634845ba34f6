"""Scene rendering (port of ``s3gaussian_tpu/render/renderer.py``: ``render``
and the forward of ``render_multicam``), differentiable.

The coarse stage rasterizes the raw pool; the fine stage routes the raw
attributes through the deformation field first, then applies the
activations.  Optional passes: the DINO feature head rendered as colours
(positions detached, as in JAX), and the dynamic/static decomposition,
which re-renders the pool masked by |dx| > mean — alive-mask variations
of the fixed-capacity pool.  ``mean2d_tap`` ([Nc,2] zeros) collects the
NDC screen gradient of the main pass for the densification statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from s3gaussian_tpu_torch.config import PipelineParams, RasterConfig
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool
from s3gaussian_tpu_torch.ops.project import sh_to_color
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings, rasterize


def make_settings(camera: Camera, bg: torch.Tensor, sh_degree: int,
                  scaling_modifier: float = 1.0) -> RasterSettings:
    return RasterSettings(
        image_height=camera.image_height, image_width=camera.image_width,
        tanfovx=camera.tanfovx, tanfovy=camera.tanfovy, bg=bg,
        scale_modifier=scaling_modifier, viewmatrix=camera.world_view,
        projmatrix=camera.full_proj, sh_degree=sh_degree,
        campos=camera.campos)


def _attributes(pool: GaussianPool, deform: Optional[DeformationField],
                time: torch.Tensor, aabb: Optional[torch.Tensor], stage: str):
    """The pool's attributes at ``time`` as the rasterizer takes them: raw
    in the coarse stage, through the deformation field in the fine one,
    then activated.  (xyz, scales, rotations, opacity [N], shs, the
    field's DeformOut or None)."""
    out = None
    if "coarse" in stage:
        xyz_f, scales_f, rot_f, op_f, shs_f = (
            pool.xyz, pool.scaling, pool.rotation, pool.opacity,
            pool.get_features())
    elif "fine" in stage:
        out = deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity,
                     pool.get_features(), time.reshape(()), aabb)
        xyz_f, scales_f, rot_f, op_f, shs_f = (out.xyz, out.scales,
                                               out.rotations, out.opacity,
                                               out.shs)
    else:
        raise NotImplementedError(stage)
    return (xyz_f, torch.exp(scales_f),
            rot_f / torch.linalg.norm(rot_f, dim=-1, keepdim=True),
            torch.sigmoid(op_f)[:, 0], shs_f, out)


def _dynamic_split(dx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The decomposition's dynamic mask: live Gaussians whose largest
    |dx| component exceeds the mean of that over the live ones."""
    mx = dx.abs().amax(1)
    thr = (torch.where(alive, mx, 0.0).sum()
           / torch.clamp(alive.sum(), min=1))
    return (mx > thr) & alive


def render(camera: Camera, pool: GaussianPool,
           deform: Optional[DeformationField], pipe: PipelineParams,
           bg: torch.Tensor, aabb: Optional[torch.Tensor] = None,
           active_sh_degree: int = 3, stage: str = "fine",
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           return_decomposition: bool = False, return_dx: bool = False,
           render_feat: bool = False,
           mean2d_tap: Optional[torch.Tensor] = None,
           cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """Render one camera.  Returns a dict with the reference's keys:
    render, depth, radii, visibility_filter, alive_work, raster_aux, and
    as asked feat, render_d/depth_d/render_s/depth_s, dx/dshs."""
    fine = "fine" in stage
    if (cfg.cull_before_deform and fine and not return_decomposition
            and override_color is None):
        raise NotImplementedError(
            "cull_before_deform (take_compact) is not ported yet; "
            "see ROADMAP.md")
    xyz = pool.xyz
    xyz_f, scales_act, rot_act, op_act, shs_f, out = _attributes(
        pool, deform, camera.time, aabb, stage)
    dx, feat, dshs = ((out.dx, out.feat, out.dshs) if out is not None
                      else (None, None, None))

    if override_color is not None:
        colors = override_color
    elif pipe.convert_SHs_python:
        # reference quirk: view directions from the *undeformed* positions
        colors = sh_to_color(shs_f, xyz, camera.campos, active_sh_degree)
    else:
        colors = None

    settings = make_settings(camera, bg, active_sh_degree, scaling_modifier)

    def rast(alive_mask, means=xyz_f, colors_precomp=colors, tap=None):
        return rasterize(settings, means, op_act, scales=scales_act,
                         rotations=rot_act,
                         shs=None if colors_precomp is not None else shs_f,
                         colors_precomp=colors_precomp, mean2d_tap=tap,
                         alive=alive_mask, cfg=cfg)

    color, radii, depth, aux = rast(pool.alive, tap=mean2d_tap)
    result: Dict[str, Any] = {
        "render": color,
        "depth": depth,
        "radii": radii,
        "visibility_filter": radii > 0,
        "alive_work": pool.alive,
        "raster_aux": aux,
    }

    if render_feat and fine and feat is not None:
        result["feat"] = rast(pool.alive, xyz_f.detach(), feat)[0]

    if return_decomposition and dx is not None:
        dyn = _dynamic_split(dx, pool.alive)
        color_d, radii_d, depth_d, _ = rast(dyn)
        color_s, radii_s, depth_s, _ = rast(pool.alive & ~dyn)
        result.update({
            "render_d": color_d, "depth_d": depth_d,
            "visibility_filter_d": radii_d > 0,
            "render_s": color_s, "depth_s": depth_s,
            "visibility_filter_s": radii_s > 0,
            "dynamic_mask": dyn,
        })

    if return_dx and fine:
        result["dx"] = dx
        result["dshs"] = dshs
    return result


def render_multicam(cameras: Sequence[Camera], pool: GaussianPool,
                    deform: Optional[DeformationField], pipe: PipelineParams,
                    bg: torch.Tensor, aabb: Optional[torch.Tensor] = None,
                    active_sh_degree: int = 3, stage: str = "fine",
                    return_decomposition: bool = False,
                    cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """Render a rig of cameras that share one time (the Waymo 3-camera
    rig at one frame) with ONE deformation evaluation; only the
    rasterization runs per camera.

    Returns per-camera stacked ``render [B,3,H,W]`` and ``depth [B,H,W]``,
    pool-shaped ``radii`` reduced by elementwise max and
    ``raster_aux.visible`` by any (the reference's batch semantics,
    train.py:489-492), ``raster_aux.vis_count`` (cameras that drew each
    Gaussian), the summed ``n_pairs``, the largest overflow counts, and
    the shared ``dx``/``dshs``/``alive_work``.  With the decomposition,
    the |dx| > mean split is made once from the shared ``dx`` and
    re-rendered per camera (``render_d``/``depth_d``/``render_s``/
    ``depth_s`` stacked, ``dynamic_mask``).  The JAX package's
    ``multicam_scan`` compiles the same loop as a scan; here the loop is
    Python whatever it says.  The feature pass and the per-camera
    ``mean2d_tap`` of the rig train step wait for it (ROADMAP.md §1 item
    4).
    """
    fine = "fine" in stage
    if cfg.cull_before_deform and fine and not return_decomposition:
        raise NotImplementedError(
            "cull_before_deform (take_compact) is not ported yet; "
            "see ROADMAP.md")
    xyz_f, scales_act, rot_act, op_act, shs_f, out = _attributes(
        pool, deform, cameras[0].time, aabb, stage)
    dx, dshs = (out.dx, out.dshs) if out is not None else (None, None)

    # reference quirk: view directions from the undeformed positions
    colors = [sh_to_color(shs_f, pool.xyz, cam.campos, active_sh_degree)
              if pipe.convert_SHs_python else None for cam in cameras]

    def rast(b, alive_mask):
        return rasterize(make_settings(cameras[b], bg, active_sh_degree),
                         xyz_f, op_act, scales=scales_act, rotations=rot_act,
                         shs=None if colors[b] is not None else shs_f,
                         colors_precomp=colors[b], alive=alive_mask, cfg=cfg)

    renders, depths = [], []
    radii_red = visible_red = vis_count = None
    n_pairs = 0
    ovf = {}
    for b in range(len(cameras)):
        color, radii, depth, aux = rast(b, pool.alive)
        renders.append(color)
        depths.append(depth)
        vis = aux["visible"]
        if radii_red is None:
            radii_red, visible_red = radii, vis
            vis_count = vis.to(torch.float32)
        else:
            radii_red = torch.maximum(radii_red, radii)
            visible_red = visible_red | vis
            vis_count = vis_count + vis.to(torch.float32)
        n_pairs = n_pairs + aux["n_pairs"]
        for k in ("overflow_rect", "overflow_visible", "overflow_pairs"):
            ovf[k] = aux[k] if k not in ovf else torch.maximum(ovf[k], aux[k])

    result: Dict[str, Any] = {
        "render": torch.stack(renders),
        "depth": torch.stack(depths),
        "radii": radii_red,
        "visibility_filter": radii_red > 0,
        "alive_work": pool.alive,
        "raster_aux": {"visible": visible_red, "vis_count": vis_count,
                       "n_pairs": n_pairs, **ovf},
        "dx": dx,
        "dshs": dshs,
    }

    if return_decomposition and dx is not None:
        dyn = _dynamic_split(dx, pool.alive)
        split = {k: [] for k in ("render_d", "depth_d", "render_s",
                                 "depth_s")}
        for b in range(len(cameras)):
            color_d, _, depth_d, _ = rast(b, dyn)
            color_s, _, depth_s, _ = rast(b, pool.alive & ~dyn)
            for k, v in (("render_d", color_d), ("depth_d", depth_d),
                         ("render_s", color_s), ("depth_s", depth_s)):
                split[k].append(v)
        result.update({k: torch.stack(v) for k, v in split.items()})
        result["dynamic_mask"] = dyn
    return result
