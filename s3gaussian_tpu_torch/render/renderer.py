"""Scene rendering (port of ``s3gaussian_tpu/render/renderer.py``:
``render`` and ``render_multicam``), differentiable.

One body renders a view, a rig of B >= 1 same-time cameras
(``render_multicam``); ``render`` is its rig of one.  The coarse stage
rasterizes the raw pool; the fine stage routes the raw attributes
through the deformation field first, once for the rig, then applies the
activations.  Optional passes: the DINO feature head rendered as colours
(positions detached, as in JAX) over its camera's RGB-pass binning, and
the dynamic/static decomposition, which re-renders the pool masked by
|dx| > mean — alive-mask variations of the fixed-capacity pool, which
bin their own.  ``mean2d_tap`` ([Nc,2] zeros, or one per camera)
collects the NDC screen gradient of the main pass for the densification
statistics.  With ``cull_before_deform`` the fine stage first culls the
undeformed pool to a working set of ``max_visible`` rows
(``ops/compact.py``).  Inside a train step the stages are marked
(``utils/spans.py``): the cull, the field forward and, through an
identity on its outputs, its backward; projection and SH per camera and
pass (``rasterize`` marks binning and compositing); the field's rows and
their visibility.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from s3gaussian_tpu_torch.config import PipelineParams, RasterConfig
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool
from s3gaussian_tpu_torch.ops.compact import (candidates, expand_by_rank,
                                              take_compact)
from s3gaussian_tpu_torch.ops.project import (build_cov3d, project_gaussians,
                                              sh_to_color)
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from s3gaussian_tpu_torch.utils import spans


def make_settings(camera: Camera, bg: torch.Tensor,
                  sh_degree: int) -> RasterSettings:
    return RasterSettings(
        image_height=camera.image_height, image_width=camera.image_width,
        tanfovx=camera.tanfovx, tanfovy=camera.tanfovy, bg=bg,
        scale_modifier=1.0, viewmatrix=camera.world_view,
        projmatrix=camera.full_proj, sh_degree=sh_degree,
        campos=camera.campos)


def _attributes(pool: GaussianPool, deform: Optional[DeformationField],
                time: torch.Tensor, aabb: Optional[torch.Tensor], stage: str):
    """The attributes of ``pool`` (the whole pool or the culled working
    set) at ``time`` as the rasterizer takes them: raw in the coarse
    stage, through the deformation field in the fine one, then activated.
    (xyz, scales, rotations, opacity [N], shs, the field's DeformOut or
    None)."""
    out = None
    if "coarse" in stage:
        xyz_f, scales_f, rot_f, op_f, shs_f = (
            pool.xyz, pool.scaling, pool.rotation, pool.opacity,
            pool.get_features())
    elif "fine" in stage:
        spans.mark("field.fwd")
        spans.count(field_rows=pool.xyz.shape[0])
        out = deform(pool.xyz, pool.scaling, pool.rotation, pool.opacity,
                     pool.get_features(), time.reshape(()), aabb)
        xyz_f, scales_f, rot_f, op_f, shs_f = (out.xyz, out.scales,
                                               out.rotations, out.opacity,
                                               out.shs)
    else:
        raise NotImplementedError(stage)
    attrs = (xyz_f, torch.exp(scales_f),
             rot_f / torch.linalg.norm(rot_f, dim=-1, keepdim=True),
             torch.sigmoid(op_f)[:, 0], shs_f)
    if out is None:
        return attrs + (None,)
    *attrs, dx, feat, dshs = spans.grad_mark("field.bwd", *attrs, out.dx,
                                             out.feat, out.dshs)
    return (*attrs, out._replace(dx=dx, feat=feat, dshs=dshs))


def cull_working_set(pool: GaussianPool, cameras: Sequence[Camera],
                     cfg: RasterConfig,
                     taps: Sequence[Optional[torch.Tensor]] = ()):
    """The pre-deformation cull: the undeformed pool projected on detached
    inputs with ``cfg.cull_margin_px`` of margin for each camera, the
    union of their visibilities ordered visible-first, the first
    ``max_visible`` rows gathered through ``take_compact``.  Returns the
    working set as a pool (``alive`` masks its real members), the union
    visibility [N] that ordered it, and each tap gathered alike."""
    with torch.no_grad():
        cov0 = build_cov3d(torch.exp(pool.scaling), pool.rotation)
        vis0 = None
        for cam in cameras:
            v = project_gaussians(
                pool.xyz, cov0, cam.world_view, cam.full_proj, cam.tanfovx,
                cam.tanfovy, cam.image_width, cam.image_height,
                tile_x=cfg.tile_x, tile_y=cfg.tile_y, alive=pool.alive,
                radius_margin=cfg.cull_margin_px).visible
            vis0 = v if vis0 is None else vis0 | v
        nr = min(cfg.max_visible, pool.capacity)
        cand = candidates(vis0, nr)
        alive_w = vis0[cand] & (torch.arange(nr, device=cand.device)
                                < vis0.sum())

    def take(x):
        return None if x is None else take_compact(x, cand, vis0)

    work = GaussianPool(xyz=take(pool.xyz),
                        features_dc=take(pool.features_dc),
                        features_rest=take(pool.features_rest),
                        scaling=take(pool.scaling),
                        rotation=take(pool.rotation),
                        opacity=take(pool.opacity), alive=alive_w)
    return work, vis0, [take(t) for t in taps]


def _dynamic_split(dx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The decomposition's dynamic mask: live Gaussians whose largest
    |dx| component exceeds the mean of that over the live ones."""
    mx = dx.abs().amax(1)
    thr = (torch.where(alive, mx, 0.0).sum()
           / torch.clamp(alive.sum(), min=1))
    return (mx > thr) & alive


# the maps a rig stacks per camera [B,...]; ``render`` takes index 0
STACKED = ("render", "depth", "feat", "render_d", "depth_d", "render_s",
           "depth_s")
# the rig's budget counters: pairs and visible rows summed over its
# cameras, the overflow counts the largest
SUMMED = ("n_pairs", "n_visible")
WORST = ("overflow_rect", "overflow_visible", "overflow_pairs")


def render_multicam(cameras: Sequence[Camera], pool: GaussianPool,
                    deform: Optional[DeformationField], pipe: PipelineParams,
                    bg: torch.Tensor, aabb: Optional[torch.Tensor] = None,
                    active_sh_degree: int = 3, stage: str = "fine",
                    return_decomposition: bool = False,
                    render_feat: bool = False,
                    mean2d_tap: Optional[torch.Tensor] = None,
                    cfg: RasterConfig = RasterConfig(),
                    override_color: Optional[torch.Tensor] = None
                    ) -> Dict[str, Any]:
    """Render a rig of B >= 1 cameras that share one time (the Waymo
    3-camera rig at one frame) with ONE deformation evaluation; only the
    rasterization runs per camera (the unrolled loop of JAX's
    ``render_multicam``; its ``multicam_scan`` core computes the same).

    Returns per-camera stacked ``render [B,3,H,W]``, ``depth [B,H,W]`` and
    with ``render_feat`` ``feat [B,3,H,W]`` (positions detached, over the
    binning of its camera's RGB pass: the same projection bins to the
    same pairs), pool-shaped ``radii`` reduced by elementwise max and
    ``raster_aux.visible`` by any (the reference's batch semantics,
    train.py:489-492), ``raster_aux.vis_count`` (cameras that drew each
    Gaussian), the summed ``n_pairs`` and ``n_visible``, the largest
    overflow counts, and the shared ``dx``/``dshs`` (None in the coarse
    stage) and ``alive_work``.  ``mean2d_tap`` is shared [Nc,2] or per
    camera [B,Nc,2].  ``override_color`` [Nc,3] colours every camera's
    pass in place of the SH colours.  With ``cfg.cull_before_deform`` in
    the fine stage (and neither the decomposition nor ``override_color``)
    one cull by the union of the rig's visibilities serves every camera
    (``max_visible`` sized for the union): dx, dshs and ``alive_work``
    are working-set shaped, and the reduced radii, visibility and counts
    are expanded back to the pool by rank once, after the loop.  With the
    decomposition (never culled), the |dx| > mean split is made once from
    the shared ``dx`` and re-rendered per camera
    (``render_d``/``depth_d``/``render_s``/``depth_s`` stacked,
    ``visibility_filter_d``/``_s`` from each split's radii reduced by
    max, ``dynamic_mask``).
    """
    fine = "fine" in stage
    n_cams = len(cameras)
    percam_tap = mean2d_tap is not None and mean2d_tap.dim() == 3
    taps = (list(mean2d_tap) if percam_tap else [mean2d_tap] * n_cams)
    vis0 = None
    if (cfg.cull_before_deform and fine and not return_decomposition
            and override_color is None):
        spans.mark("cull")
        pool, vis0, taps = cull_working_set(pool, cameras, cfg, taps=(
            taps if percam_tap else taps[:1]))
        if not percam_tap:
            taps = taps * n_cams
    xyz_f, scales_act, rot_act, op_act, shs_f, out = _attributes(
        pool, deform, cameras[0].time, aabb, stage)
    dx, dshs, feat = ((out.dx, out.dshs, out.feat) if out is not None
                      else (None, None, None))

    spans.mark("project.fwd")
    if override_color is not None:
        colors = [override_color] * n_cams
    else:
        # reference quirk: view directions from the undeformed positions
        colors = [sh_to_color(shs_f, pool.xyz, cam.campos, active_sh_degree)
                  if pipe.convert_SHs_python else None for cam in cameras]

    settings = [make_settings(cam, bg, active_sh_degree) for cam in cameras]

    def rast(b, alive_mask, tap=None):
        return rasterize(settings[b], xyz_f, op_act, scales=scales_act,
                         rotations=rot_act,
                         shs=None if colors[b] is not None else shs_f,
                         colors_precomp=colors[b], mean2d_tap=tap,
                         alive=alive_mask, cfg=cfg)

    renders, depths, feats = [], [], []
    for b in range(n_cams):
        color, radii, depth, aux = rast(b, pool.alive, taps[b])
        renders.append(color)
        depths.append(depth)
        vis = aux["visible"]
        if b == 0:
            radii_red, visible_red = radii, vis
            vis_count = vis.to(torch.float32)
            counts = {k: aux[k] for k in SUMMED + WORST}
        else:
            radii_red = torch.maximum(radii_red, radii)
            visible_red = visible_red | vis
            vis_count = vis_count + vis.to(torch.float32)
            counts.update({k: counts[k] + aux[k] for k in SUMMED})
            counts.update({k: torch.maximum(counts[k], aux[k])
                           for k in WORST})
        if render_feat and fine and feat is not None:
            feats.append(rasterize(
                settings[b], xyz_f.detach(), op_act, scales=scales_act,
                rotations=rot_act, colors_precomp=feat, alive=pool.alive,
                cfg=cfg, binning=aux["binning"])[0])
    if out is not None:
        spans.count(visible=visible_red)
    if vis0 is not None:
        # the reductions commute with the expansion: one after the loop
        radii_red, visible_red, vis_count = (
            expand_by_rank(x, vis0)
            for x in (radii_red, visible_red, vis_count))

    result: Dict[str, Any] = {
        "render": torch.stack(renders),
        "depth": torch.stack(depths),
        "radii": radii_red,
        "visibility_filter": radii_red > 0,
        "alive_work": pool.alive,
        "raster_aux": {"visible": visible_red, "vis_count": vis_count,
                       **counts},
        "dx": dx,
        "dshs": dshs,
    }
    if feats:
        result["feat"] = torch.stack(feats)

    if return_decomposition and dx is not None:
        dyn = _dynamic_split(dx, pool.alive)
        for s, mask in (("d", dyn), ("s", pool.alive & ~dyn)):
            color, radii, depth = zip(*(rast(b, mask)[:3]
                                        for b in range(n_cams)))
            result[f"render_{s}"] = torch.stack(color)
            result[f"depth_{s}"] = torch.stack(depth)
            result[f"visibility_filter_{s}"] = torch.stack(radii).amax(0) > 0
        result["dynamic_mask"] = dyn
    return result


def render(camera: Camera, pool: GaussianPool,
           deform: Optional[DeformationField], pipe: PipelineParams,
           bg: torch.Tensor, aabb: Optional[torch.Tensor] = None,
           active_sh_degree: int = 3, stage: str = "fine",
           override_color: Optional[torch.Tensor] = None,
           return_decomposition: bool = False, render_feat: bool = False,
           mean2d_tap: Optional[torch.Tensor] = None,
           cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """Render one camera: ``render_multicam`` on a rig of one, each map
    of ``STACKED`` taken at index 0, every other key as the rig gives it
    (``mean2d_tap`` [Nc,2])."""
    pkg = render_multicam([camera], pool, deform, pipe, bg, aabb,
                          active_sh_degree, stage, return_decomposition,
                          render_feat, mean2d_tap, cfg, override_color)
    return {k: v[0] if k in STACKED else v for k, v in pkg.items()}
