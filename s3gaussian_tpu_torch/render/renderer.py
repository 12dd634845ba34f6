"""Scene rendering (port of ``s3gaussian_tpu/render/renderer.py``:
``render`` and ``render_multicam``), differentiable.

The coarse stage rasterizes the raw pool; the fine stage routes the raw
attributes through the deformation field first, then applies the
activations.  Optional passes: the DINO feature head rendered as colours
(positions detached, as in JAX), and the dynamic/static decomposition,
which re-renders the pool masked by |dx| > mean — alive-mask variations
of the fixed-capacity pool.  ``mean2d_tap`` ([Nc,2] zeros) collects the
NDC screen gradient of the main pass for the densification statistics.
With ``cull_before_deform`` the fine stage first culls the undeformed
pool to a working set of ``max_visible`` rows (``ops/compact.py``).
Inside a train step the stages are marked (``utils/spans.py``): the
cull, the field forward and, through an identity on its outputs, its
backward; projection and SH per camera and pass (``rasterize`` marks
binning and compositing); the field's rows and their visibility.  The
feature pass takes its camera's RGB-pass binning (``_feature_pass``); the
decomposition passes, whose alive masks differ, bin their own.
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
from s3gaussian_tpu_torch.ops.rasterizer import (Binning, RasterSettings,
                                                 rasterize)
from s3gaussian_tpu_torch.utils import spans


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
                     cfg: RasterConfig, scaling_modifier: float = 1.0,
                     taps: Sequence[Optional[torch.Tensor]] = ()):
    """The pre-deformation cull: the undeformed pool projected on detached
    inputs with ``cfg.cull_margin_px`` of margin for each camera, the
    union of their visibilities ordered visible-first, the first
    ``max_visible`` rows gathered through ``take_compact``.  Returns the
    working set as a pool (``alive`` masks its real members), the union
    visibility [N] that ordered it, and each tap gathered alike."""
    with torch.no_grad():
        cov0 = build_cov3d(torch.exp(pool.scaling), pool.rotation,
                           scaling_modifier)
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


def _feature_pass(settings: RasterSettings, means: torch.Tensor,
                  opacity: torch.Tensor, scales: torch.Tensor,
                  rotations: torch.Tensor, feat: torch.Tensor,
                  alive: torch.Tensor, cfg: RasterConfig,
                  binning: Binning) -> torch.Tensor:
    """The DINO feature map rendered as colours (positions detached, no
    tap) over the geometry and alive mask of the camera's RGB pass, whose
    ``binning`` it takes: the same projection bins to the same pairs."""
    return rasterize(settings, means.detach(), opacity, scales=scales,
                     rotations=rotations, colors_precomp=feat, alive=alive,
                     cfg=cfg, binning=binning)[0]


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
    as asked feat, render_d/depth_d/render_s/depth_s, dx/dshs.

    With ``cfg.cull_before_deform`` in the fine stage (and neither the
    decomposition nor ``override_color``) the field and the rasterizer
    run on the culled working set: dx, dshs and ``alive_work`` are
    working-set shaped, radii and visibility are expanded back to the
    pool by rank."""
    fine = "fine" in stage
    vis0 = None
    if (cfg.cull_before_deform and fine and not return_decomposition
            and override_color is None):
        spans.mark("cull")
        pool, vis0, (mean2d_tap,) = cull_working_set(
            pool, [camera], cfg, scaling_modifier, [mean2d_tap])
    xyz = pool.xyz
    xyz_f, scales_act, rot_act, op_act, shs_f, out = _attributes(
        pool, deform, camera.time, aabb, stage)
    dx, feat, dshs = ((out.dx, out.feat, out.dshs) if out is not None
                      else (None, None, None))

    spans.mark("project.fwd")
    if override_color is not None:
        colors = override_color
    elif pipe.convert_SHs_python:
        # reference quirk: view directions from the *undeformed* positions
        colors = sh_to_color(shs_f, xyz, camera.campos, active_sh_degree)
    else:
        colors = None

    settings = make_settings(camera, bg, active_sh_degree, scaling_modifier)

    def rast(alive_mask, tap=None):
        return rasterize(settings, xyz_f, op_act, scales=scales_act,
                         rotations=rot_act,
                         shs=None if colors is not None else shs_f,
                         colors_precomp=colors, mean2d_tap=tap,
                         alive=alive_mask, cfg=cfg)

    color, radii, depth, aux = rast(pool.alive, tap=mean2d_tap)
    if out is not None:
        spans.count(visible=aux["visible"])
    if vis0 is not None:
        radii = expand_by_rank(radii, vis0)
        aux = {**aux, "visible": expand_by_rank(aux["visible"], vis0)}
    result: Dict[str, Any] = {
        "render": color,
        "depth": depth,
        "radii": radii,
        "visibility_filter": radii > 0,
        "alive_work": pool.alive,
        "raster_aux": aux,
    }

    if render_feat and fine and feat is not None:
        result["feat"] = _feature_pass(settings, xyz_f, op_act, scales_act,
                                       rot_act, feat, pool.alive, cfg,
                                       aux["binning"])

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
                    render_feat: bool = False,
                    mean2d_tap: Optional[torch.Tensor] = None,
                    cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """Render a rig of cameras that share one time (the Waymo 3-camera
    rig at one frame) with ONE deformation evaluation; only the
    rasterization runs per camera (the unrolled loop of JAX's
    ``render_multicam``; its ``multicam_scan`` core computes the same).

    Returns per-camera stacked ``render [B,3,H,W]``, ``depth [B,H,W]`` and
    with ``render_feat`` ``feat [B,3,H,W]`` (positions detached),
    pool-shaped ``radii`` reduced by elementwise max and
    ``raster_aux.visible`` by any (the reference's batch semantics,
    train.py:489-492), ``raster_aux.vis_count`` (cameras that drew each
    Gaussian), the summed ``n_pairs``, the largest overflow counts, and
    the shared ``dx``/``dshs``/``alive_work``.  ``mean2d_tap`` is shared
    [Nc,2] or per camera [B,Nc,2].  With ``cfg.cull_before_deform`` in
    the fine stage one cull by the union of the rig's visibilities serves
    every camera (``max_visible`` sized for the union), and the reduced
    radii, visibility and counts are expanded back to the pool once,
    after the loop.  With the decomposition (never culled), the
    |dx| > mean split is made once from the shared ``dx`` and re-rendered
    per camera (``render_d``/``depth_d``/``render_s``/``depth_s``
    stacked, ``dynamic_mask``).
    """
    fine = "fine" in stage
    n_cams = len(cameras)
    percam_tap = mean2d_tap is not None and mean2d_tap.dim() == 3
    taps = (list(mean2d_tap) if percam_tap else [mean2d_tap] * n_cams)
    vis0 = None
    if cfg.cull_before_deform and fine and not return_decomposition:
        spans.mark("cull")
        pool, vis0, taps = cull_working_set(pool, cameras, cfg, taps=(
            taps if percam_tap else taps[:1]))
        if not percam_tap:
            taps = taps * n_cams
    xyz_f, scales_act, rot_act, op_act, shs_f, out = _attributes(
        pool, deform, cameras[0].time, aabb, stage)
    dx, dshs, feat = ((out.dx, out.dshs, out.feat) if out is not None
                      else (None, None, None))

    # reference quirk: view directions from the undeformed positions
    spans.mark("project.fwd")
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
    radii_red = visible_red = vis_count = None
    n_pairs = 0
    ovf = {}
    for b in range(n_cams):
        color, radii, depth, aux = rast(b, pool.alive, taps[b])
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
        if render_feat and fine and feat is not None:
            feats.append(_feature_pass(settings[b], xyz_f, op_act,
                                       scales_act, rot_act, feat, pool.alive,
                                       cfg, aux["binning"]))
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
                       "n_pairs": n_pairs, **ovf},
        "dx": dx,
        "dshs": dshs,
    }
    if feats:
        result["feat"] = torch.stack(feats)

    if return_decomposition and dx is not None:
        dyn = _dynamic_split(dx, pool.alive)
        split = {k: [] for k in ("render_d", "depth_d", "render_s",
                                 "depth_s")}
        for b in range(n_cams):
            color_d, _, depth_d, _ = rast(b, dyn)
            color_s, _, depth_s, _ = rast(b, pool.alive & ~dyn)
            for k, v in (("render_d", color_d), ("depth_d", depth_d),
                         ("render_s", color_s), ("depth_s", depth_s)):
                split[k].append(v)
        result.update({k: torch.stack(v) for k, v in split.items()})
        result["dynamic_mask"] = dyn
    return result
