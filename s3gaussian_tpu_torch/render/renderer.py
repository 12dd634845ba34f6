"""Scene rendering (port of ``s3gaussian_tpu/render/renderer.py::render``),
differentiable.

The coarse stage rasterizes the raw pool; the fine stage routes the raw
attributes through the deformation field first, then applies the
activations.  Optional passes: the DINO feature head rendered as colours
(positions detached, as in JAX), and the dynamic/static decomposition,
which re-renders the pool masked by |dx| > mean — alive-mask variations
of the fixed-capacity pool.  ``mean2d_tap`` ([Nc,2] zeros) collects the
NDC screen gradient of the main pass for the densification statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
    shs = pool.get_features()
    dx = dshs = feat = None
    if "coarse" in stage:
        xyz_f, scales_f, rot_f, op_f, shs_f = (xyz, pool.scaling,
                                               pool.rotation, pool.opacity,
                                               shs)
    elif fine:
        out = deform(xyz, pool.scaling, pool.rotation, pool.opacity, shs,
                     camera.time.reshape(()), aabb)
        xyz_f, scales_f, rot_f, op_f, shs_f = (out.xyz, out.scales,
                                               out.rotations, out.opacity,
                                               out.shs)
        dx, feat, dshs = out.dx, out.feat, out.dshs
    else:
        raise NotImplementedError(stage)

    scales_act = torch.exp(scales_f)
    rot_act = rot_f / torch.linalg.norm(rot_f, dim=-1, keepdim=True)
    op_act = torch.sigmoid(op_f)[:, 0]

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
        mx = dx.abs().amax(1)
        alive = pool.alive
        thr = (torch.where(alive, mx, 0.0).sum()
               / torch.clamp(alive.sum(), min=1))
        dyn = (mx > thr) & alive
        color_d, radii_d, depth_d, _ = rast(dyn)
        color_s, radii_s, depth_s, _ = rast(alive & ~dyn)
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
