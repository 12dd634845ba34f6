"""The train step, coarse and fine, on a same-time rig of B >= 1 cameras
(port of ``s3gaussian_tpu/train/trainer.py``: ``TrainState``,
``init_state``, ``reinit_optimizer``, ``lr_dict``,
``compute_loss_multicam``, ``apply_param_update``, ``train_step``,
``train_step_multicam``, ``train_steps_scan``,
``train_steps_scan_multicam``, density control and ``probe_pool``).

  loss = L1(rgb)
       + λ_dx·mean|dx| + λ_dshs·mean|dshs|              (fine)
       + λ_depth·masked-L2(normalized depth)
       + hexplane TV/time/L1 regs                       (fine, a grid)
       + λ_dssim·(1−SSIM)
       + λ_feat·L2(feat, dino_gt)                       (fine, feat_head)

A step (``train_step_multicam``) is an eager call: render forward and
backward through the CUDA compositors, with one field evaluation for
the rig's cameras, the losses pooled over the stacked renders,
dead-row gradient masking, the NaN watchdog, the scheduled per-group
Adam and the densification statistics fed by the gradient of the
``mean2d_tap``.  It writes every output into the state's own tensors
(parameters, moments, ``count``, statistics, ``step``, ``nan_skips``),
as donation does in JAX, and returns that state.  ``train_step`` is
that step on a rig of one at the unscaled learning rates.
``densify_step`` and ``opacity_reset_step`` edit the pool's rows and
their Adam moments and return a new state.

A step marks its stages (``utils/spans.py``: the cull, the field, per
camera and pass projection, binning and compositing, the loss, each of
their backward passes, the update) and returns their device time by
name, ``span_ns``, the field's ``field_rows`` and ``visible_rows`` and
the rasterizer's ``raster_passes``, ``bins_reused`` and ``bins_kernel``
beside its aux.

``train_steps_scan`` and ``train_steps_scan_multicam`` run a block of
steps, JAX's unit of dispatch: on the card N replays of the step
captured as one CUDA graph (``train/graphs.py``), with no host read in
between; on the CPU a loop of the eager step.  Both return the state
and the per-step ``small_aux`` stacked on a leading step axis; a block
dispatched under a profiler keeps its span counters in the span record.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                         OptimizationParams, PipelineParams,
                                         RasterConfig)
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.models import hexplane as hx
from s3gaussian_tpu_torch.models.fields import Field
from s3gaussian_tpu_torch.models.pool import (GaussianPool, PoolStats,
                                              add_densification_stats,
                                              densify_and_prune,
                                              reset_opacity)
from s3gaussian_tpu_torch.render.renderer import render_multicam
from s3gaussian_tpu_torch.train.losses import (depth_loss, l1_loss, l2_loss,
                                               psnr, ssim)
from s3gaussian_tpu_torch.train.lr import expon_lr
from s3gaussian_tpu_torch.train.optim import (B1, B2, EPS, AdamState,
                                              adam_update, init_adam,
                                              path_group)
from s3gaussian_tpu_torch.utils import spans


@dataclass
class TrainState:
    pool: GaussianPool
    deform: Field
    adam: AdamState
    stats: PoolStats
    step: torch.Tensor        # [] int32
    aabb: torch.Tensor        # [2,3] (max; min)
    nan_skips: torch.Tensor   # [] int32


def param_tree(pool: GaussianPool, deform: Field
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"pool": pool.param_dict(), "deform": {name: parameter}}."""
    return {"pool": pool.param_dict(),
            "deform": dict(deform.named_parameters())}


def init_state(pool: GaussianPool, deform: Field,
               aabb: torch.Tensor) -> TrainState:
    dev = pool.xyz.device
    return TrainState(pool=pool, deform=deform,
                      adam=init_adam(param_tree(pool, deform)),
                      stats=PoolStats.zeros(pool.capacity, dev),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      aabb=aabb,
                      nan_skips=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def reinit_optimizer(state: TrainState) -> TrainState:
    """A stage starts with fresh Adam moments, a stage-local step for the
    schedules and zeroed densification statistics (reference
    train.py:222, gaussian_model.py:181-185)."""
    dev = state.pool.xyz.device
    return replace(state, adam=init_adam(param_tree(state.pool,
                                                    state.deform)),
                   step=torch.zeros((), dtype=torch.int32, device=dev),
                   stats=PoolStats.zeros(state.pool.capacity, dev))


def lr_dict(step: torch.Tensor, opt: OptimizationParams,
            spatial_lr_scale: float) -> Dict[str, torch.Tensor]:
    """Scheduled per-group learning rates (gaussian_model.py:186-218),
    0-d tensors on the step's device."""
    s = spatial_lr_scale

    def const(v):
        # a fill on the device: a tensor made from a host value would be
        # a host-to-device copy in every step
        return torch.full((), v, dtype=torch.float32, device=step.device)

    return {
        "xyz": expon_lr(step, opt.position_lr_init * s,
                        opt.position_lr_final * s,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps),
        "deformation": expon_lr(step, opt.deformation_lr_init * s,
                                opt.deformation_lr_final * s,
                                lr_delay_mult=opt.deformation_lr_delay_mult,
                                max_steps=opt.position_lr_max_steps),
        "grid": expon_lr(step, opt.grid_lr_init * s, opt.grid_lr_final * s,
                         lr_delay_mult=opt.deformation_lr_delay_mult,
                         max_steps=opt.position_lr_max_steps),
        "f_dc": const(opt.feature_lr),
        "f_rest": const(opt.feature_lr / 20.0),
        "opacity": const(opt.opacity_lr),
        "scaling": const(opt.scaling_lr),
        "rotation": const(opt.rotation_lr),
    }


def compute_loss_multicam(pool: GaussianPool, deform: Field,
                          tap: torch.Tensor, cameras: Sequence[Camera],
                          stage: str, active_sh_degree: int,
                          hp: ModelHiddenParams, opt: OptimizationParams,
                          pipe: PipelineParams, aabb: torch.Tensor,
                          bg: torch.Tensor, cfg: RasterConfig
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The loss of a rig of B >= 1 same-time cameras, pooled over the
    stacked [B,...] renders as the reference's ``batch_size > 1`` loop
    pools its ``torch.cat`` (depth pools its valid mask over the rig);
    the dx, dshs and hexplane terms once, as the rig shares one field
    evaluation.  ``tap`` is shared [Nc,2] or per camera [B,Nc,2].
    Returns (loss, aux of radii, visibility, ``vis_count``, budget
    counters and a ``metrics`` dict of 0-d tensors)."""
    fine = "fine" in stage
    want_feat = (fine and hp.feat_head
                 and all(c.feat_map is not None for c in cameras))
    pkg = render_multicam(cameras, pool, deform if fine else None, pipe, bg,
                          aabb, active_sh_degree, stage=stage,
                          render_feat=want_feat, mean2d_tap=tap, cfg=cfg)

    spans.mark("loss.fwd")
    gt = torch.stack([c.image.permute(2, 0, 1) for c in cameras])
    gt_depth = (torch.stack([c.depth_map for c in cameras])
                if all(c.depth_map is not None for c in cameras) else None)
    loss = l1_loss(pkg["render"], gt)
    metrics = {"l1": loss, "psnr": psnr(pkg["render"], gt)}

    # dx/dshs live on the render working set (the whole pool, or the
    # culled candidates with cull_before_deform); the dshs and feature
    # terms run where the field gives those outputs (Deformable 3D
    # Gaussians' gives neither)
    w_alive = pkg["alive_work"]
    n_alive = torch.clamp(w_alive.sum(), min=1)
    if fine and not hp.no_dx and opt.lambda_dx != 0:
        dx_l = (torch.where(w_alive[:, None], torch.abs(pkg["dx"]), 0.0).sum()
                / (n_alive * 3))
        loss = loss + opt.lambda_dx * dx_l
        metrics["dx"] = dx_l
    if (fine and not hp.no_dshs and opt.lambda_dshs != 0
            and pkg["dshs"] is not None):
        dshs_l = (torch.where(w_alive[:, None, None], torch.abs(pkg["dshs"]),
                              0.0).sum() / (n_alive * 48))
        loss = loss + opt.lambda_dshs * dshs_l
    if opt.lambda_depth != 0 and gt_depth is not None:
        dl = depth_loss(pkg["depth"], gt_depth, "l2")
        loss = loss + opt.lambda_depth * dl
        metrics["depth"] = dl
    # the hexplane regularisers, for a field that has a grid
    if fine and hp.time_smoothness_weight != 0 and hasattr(deform, "grid"):
        reg = hx.compute_regulation(deform.grid, len(hp.multires),
                                    hp.time_smoothness_weight,
                                    hp.l1_time_planes, hp.plane_tv_weight)
        loss = loss + reg
        metrics["reg"] = reg
    if opt.lambda_dssim != 0:
        s = ssim(pkg["render"], gt)
        loss = loss + opt.lambda_dssim * (1.0 - s)
        metrics["ssim"] = s
    if want_feat and "feat" in pkg:
        gt_feat = torch.stack([c.feat_map.permute(2, 0, 1) for c in cameras])
        fl = l2_loss(pkg["feat"], gt_feat) * opt.lambda_feat
        loss = loss + fl
        metrics["feat"] = fl

    metrics["loss"] = loss
    raster = pkg["raster_aux"]
    aux = {"radii": pkg["radii"],
           **{k: raster[k] for k in ("visible", "vis_count", "n_pairs",
                                     "overflow_rect", "overflow_visible",
                                     "overflow_pairs")},
           "metrics": {k: v.detach() for k, v in metrics.items()}}
    return loss, aux


@torch.no_grad()
def apply_param_update(state: TrainState, grads, tap_grad: torch.Tensor,
                       loss: torch.Tensor, radii: torch.Tensor,
                       visible: torch.Tensor, opt: OptimizationParams,
                       spatial_lr_scale: float, lr_scale: float = 1.0,
                       vis_count: Optional[torch.Tensor] = None
                       ) -> TrainState:
    """Post-gradient half of a step: dead-row gradient masking, the NaN
    watchdog, the scheduled learning rates times ``lr_scale``, Adam and
    the densification statistics, all written into ``state``'s own
    tensors (a captured step's next replay reads what this one wrote, at
    the same addresses); returns ``state``.  With ``vis_count`` (the
    rig step's per-camera statistics) ``tap_grad`` is the precomputed
    per-Gaussian sum of the cameras' screen-gradient norms [Nc] and
    ``vis_count`` the denominator's increment."""
    spans.mark("update")
    # dead pool slots never move: their placeholder values keep all
    # downstream math finite
    alive = state.pool.alive
    grads["pool"] = {
        k: torch.where(alive.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0.0)
        for k, v in grads["pool"].items()}

    # NaN watchdog: on a non-finite loss, zero the gradients AND the
    # learning rates (stale momentum must not move parameters either) and
    # gate the tap so one bad step cannot poison the statistics
    finite = torch.isfinite(loss)
    grads = {g: {k: torch.where(finite, v, 0.0) for k, v in d.items()}
             for g, d in grads.items()}
    tap_grad = torch.where(finite, tap_grad, 0.0)

    fin = finite.to(torch.float32) * lr_scale
    lrs = {k: v * fin for k, v in
           lr_dict(state.step, opt, spatial_lr_scale).items()}
    params = param_tree(state.pool, state.deform)
    adam_update(params, grads, state.adam,
                lambda group, name: lrs[path_group(group, name)])
    if vis_count is None:
        stats = add_densification_stats(state.stats, tap_grad, radii,
                                        visible)
    else:
        stats = add_densification_stats(state.stats, None, radii, visible,
                                        grad_norm=tap_grad,
                                        denom_inc=vis_count)
    for f in fields(stats):
        getattr(state.stats, f.name).copy_(getattr(stats, f.name))
    state.step.add_(1)
    state.nan_skips.add_((~finite).to(torch.int32))
    return state


def step_forward(state: TrainState, camera: Camera | Sequence[Camera],
                 stage: str, active_sh_degree: int, hp: ModelHiddenParams,
                 opt: OptimizationParams, pipe: PipelineParams,
                 cfg: RasterConfig, bg: torch.Tensor):
    """The forward half of a step: the loss (``compute_loss_multicam``)
    over leaf views of the pool's tensors, the field's parameters and a
    zero ``mean2d_tap``.  A list of same-time cameras is a rig, with a
    per-camera tap [B,Nc,2] when ``opt.multicam_percam_stats``, else a
    shared one [Nc,2]; a bare camera renders as a rig of one with a
    shared tap.  Returns (loss, aux, params tree, tap)."""
    pool = state.pool.with_params({k: v.detach().requires_grad_(True)
                                   for k, v in
                                   state.pool.param_dict().items()})
    rig = isinstance(camera, (list, tuple))
    cameras = list(camera) if rig else [camera]
    shape = ((len(cameras),) if rig and opt.multicam_percam_stats else ()) \
        + (pool.capacity, 2)
    tap = torch.zeros(shape, device=pool.xyz.device, requires_grad=True)
    loss, aux = compute_loss_multicam(pool, state.deform, tap, cameras,
                                      stage, active_sh_degree, hp, opt,
                                      pipe, state.aabb, bg, cfg)
    return loss, aux, param_tree(pool, state.deform), tap


def step_gradients(loss: torch.Tensor, tree, tap: torch.Tensor):
    """The backward half: gradients of every tensor of ``tree`` (zeros
    where the loss does not reach it) and of the tap."""
    leaves = [v for d in tree.values() for v in d.values()] + [tap]
    spans.mark("loss.bwd")
    flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = [torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves, flat)]
    grads, i = {}, 0
    for g, d in tree.items():
        grads[g] = dict(zip(d, flat[i:i + len(d)]))
        i += len(d)
    return grads, flat[-1]


def rig_stats(tap_grad: torch.Tensor, aux: Dict[str, Any]
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The statistics terms of a step, (tap term, ``vis_count``), by the
    tap's shape: a per-camera tap's gradient [B,Nc,2] becomes
    Σ_b ‖g_b·B‖ (the batch loss is a mean over the B cameras) and the
    denominator grows by ``vis_count``; a shared tap's gradient [Nc,2]
    is the term itself, with no count."""
    if tap_grad.dim() == 2:
        return tap_grad, None
    return (torch.linalg.norm(tap_grad[..., :2] * tap_grad.shape[0],
                              dim=-1).sum(0), aux["vis_count"])


def rig_update(state: TrainState, grads, tap_grad: torch.Tensor,
               loss: torch.Tensor, aux: Dict[str, Any],
               opt: OptimizationParams, spatial_lr_scale: float
               ) -> TrainState:
    """``apply_param_update`` of a step: the terms of ``rig_stats``,
    every learning rate scaled by ``opt.multicam_lr_scale``."""
    spans.mark("update")
    tap_term, vis_count = rig_stats(tap_grad, aux)
    return apply_param_update(state, grads, tap_term, loss, aux["radii"],
                              aux["visible"], opt, spatial_lr_scale,
                              lr_scale=opt.multicam_lr_scale,
                              vis_count=vis_count)


def unscaled(opt: OptimizationParams) -> OptimizationParams:
    """``opt`` as a single-camera step reads it: that step is the rig
    step on a rig of one at the unscaled learning rates
    (``multicam_lr_scale`` 1)."""
    return replace(opt, multicam_lr_scale=1.0)


@spans.step
def train_step_multicam(state: TrainState, cameras: Sequence[Camera],
                        stage: str, active_sh_degree: int,
                        hp: ModelHiddenParams, opt: OptimizationParams,
                        pipe: PipelineParams, cfg: RasterConfig,
                        spatial_lr_scale: float, bg: torch.Tensor
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimizer step over a rig of same-time cameras: one field
    evaluation, ``len(cameras)`` rasterizations."""
    loss, aux, tree, tap = step_forward(state, list(cameras), stage,
                                        active_sh_degree, hp, opt, pipe, cfg,
                                        bg)
    grads, tap_grad = step_gradients(loss, tree, tap)
    return rig_update(state, grads, tap_grad, loss.detach(), aux, opt,
                      spatial_lr_scale), aux


def train_step(state: TrainState, camera: Camera, stage: str,
               active_sh_degree: int, hp: ModelHiddenParams,
               opt: OptimizationParams, pipe: PipelineParams,
               cfg: RasterConfig, spatial_lr_scale: float, bg: torch.Tensor
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimizer step on one camera, stage "coarse" or "fine": the
    rig step on ``[camera]`` under ``unscaled(opt)``."""
    return train_step_multicam(state, [camera], stage, active_sh_degree, hp,
                               unscaled(opt), pipe, cfg, spatial_lr_scale, bg)


def small_aux(aux: Dict[str, Any]) -> Dict[str, Any]:
    """The per-step scalars a block of steps returns (JAX's
    ``_small_aux``): the metrics, the pair count, the three overflow
    counters, and of the screen radii the largest visible one and the
    number of visible ones above 20 px, the size-prune threshold; and
    the step's span counters (``spans.KEYS``), where it has them."""
    radii = aux["radii"].to(torch.float32)
    vis = aux["visible"]
    out = {"metrics": dict(aux["metrics"])}
    out.update({k: aux[k] for k in ("n_pairs", "overflow_rect",
                                     "overflow_visible", "overflow_pairs")})
    out["radii_max"] = torch.where(vis, radii, 0.0).amax()
    out["n_r20"] = ((radii > 20.0) & vis).sum(dtype=torch.int32)
    out.update({k: aux[k] for k in spans.KEYS if k in aux})
    return out


def stack_aux(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """``small_aux`` of each step stacked on a leading step axis."""
    out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]
           if k != "metrics"}
    out["metrics"] = {k: torch.stack([r["metrics"][k] for r in rows])
                      for k in rows[0]["metrics"]}
    return out


def last_step(aux: Dict[str, Any]) -> Dict[str, Any]:
    """The last step's row of a block's stacked ``small_aux``."""
    return {k: ({m: x[-1] for m, x in v.items()} if k == "metrics"
                else v[-1]) for k, v in aux.items()}


def scan_steps(step, state: TrainState, views: Sequence, stage: str,
               active_sh_degree: int, hp: ModelHiddenParams,
               opt: OptimizationParams, pipe: PipelineParams,
               cfg: RasterConfig, spatial_lr_scale: float, bg: torch.Tensor,
               marks: Optional[List[Any]] = None
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """A block of ``step``s (``train_step``, ``train_step_multicam`` or
    their data-parallel forms), one a view of ``views``: on the card
    replays of the step's CUDA graph (``graphs.replay_steps``, where
    ``marks`` receives a CUDA event recorded before the first step and
    after each), elsewhere a loop of the eager step.  Returns the state
    and the ``small_aux`` of every step, stacked; under a profiler the
    span record keeps the block's span counters."""
    traced = torch.autograd._profiler_enabled()
    if state.pool.xyz.device.type == "cuda":
        from s3gaussian_tpu_torch.train.graphs import replay_steps
        state, aux = replay_steps(step, state, views, stage,
                                  active_sh_degree, hp, opt, pipe, cfg,
                                  spatial_lr_scale, bg, marks)
    else:
        rows = []
        for view in views:
            state, aux = step(state, view, stage, active_sh_degree, hp, opt,
                              pipe, cfg, spatial_lr_scale, bg)
            rows.append(small_aux(aux))
        aux = stack_aux(rows)
    if traced:
        spans.keep(aux)
    return state, aux


def train_steps_scan(state: TrainState, cameras: Sequence[Camera],
                     stage: str, active_sh_degree: int,
                     hp: ModelHiddenParams, opt: OptimizationParams,
                     pipe: PipelineParams, cfg: RasterConfig,
                     spatial_lr_scale: float, bg: torch.Tensor,
                     marks: Optional[List[Any]] = None
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    """``len(cameras)`` train steps in one dispatch, one camera each (JAX's
    ``train_steps_scan``): what as many ``train_step`` calls compute."""
    return scan_steps(train_step, state, list(cameras), stage,
                      active_sh_degree, hp, opt, pipe, cfg, spatial_lr_scale,
                      bg, marks)


def train_steps_scan_multicam(state: TrainState,
                              rigs: Sequence[Sequence[Camera]], n_cams: int,
                              stage: str, active_sh_degree: int,
                              hp: ModelHiddenParams,
                              opt: OptimizationParams, pipe: PipelineParams,
                              cfg: RasterConfig, spatial_lr_scale: float,
                              bg: torch.Tensor,
                              marks: Optional[List[Any]] = None
                              ) -> Tuple[TrainState, Dict[str, Any]]:
    """``len(rigs)`` rig steps of ``n_cams`` same-time cameras in one
    dispatch (JAX's ``train_steps_scan_multicam``): what as many
    ``train_step_multicam`` calls compute."""
    rigs = [list(r) for r in rigs]
    if any(len(r) != n_cams for r in rigs):
        raise ValueError(f"rigs of {[len(r) for r in rigs]} cameras for "
                         f"n_cams={n_cams}")
    return scan_steps(train_step_multicam, state, rigs, stage,
                      active_sh_degree, hp, opt, pipe, cfg, spatial_lr_scale,
                      bg, marks)


def _pool_rows(state: TrainState) -> Dict[str, Tuple[torch.Tensor, ...]]:
    return {name: (state.adam.mu["pool"][name], state.adam.nu["pool"][name])
            for name in state.pool.param_dict()}


def _with_pool_rows(state: TrainState, pool: GaussianPool, rows,
                    **changes) -> TrainState:
    adam = AdamState(
        mu={"pool": {k: v[0] for k, v in rows.items()},
            "deform": state.adam.mu["deform"]},
        nu={"pool": {k: v[1] for k, v in rows.items()},
            "deform": state.adam.nu["deform"]},
        count=state.adam.count)
    return replace(state, pool=pool, adam=adam, **changes)


@torch.no_grad()
def densify_step(state: TrainState, generator: torch.Generator,
                 grad_threshold: float, opacity_threshold: float,
                 scene_extent: float, max_screen_size: Optional[float],
                 opt: OptimizationParams, world_prune: Optional[bool] = None,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Clone + split + prune with the Adam-row surgery (reference
    train.py:489-516).  The split noise, two standard-normal [Nc, 3]
    draws, is ``noise`` or else drawn from ``generator``, which lives on
    the pool's device.  Returns the new state (statistics zeroed) and the
    info dict of 0-d tensors."""
    pool = state.pool
    if noise is None:
        noise = torch.randn((2,) + tuple(pool.xyz.shape), generator=generator,
                            device=pool.xyz.device)
    new_pool, rows, stats, info = densify_and_prune(
        pool, _pool_rows(state), state.stats, (noise[0], noise[1]),
        grad_threshold, opacity_threshold, scene_extent, opt.percent_dense,
        max_screen_size, max_points=2_000_000,
        size_prune_cap=opt.size_prune_cap, world_prune=world_prune)
    return _with_pool_rows(state, new_pool, rows, stats=stats), info


@torch.no_grad()
def opacity_reset_step(state: TrainState) -> TrainState:
    pool, rows = reset_opacity(state.pool, _pool_rows(state))
    return _with_pool_rows(state, pool, rows)


@torch.no_grad()
def probe_pool(state: TrainState, opt: OptimizationParams,
               spatial_lr_scale: float) -> Dict[str, torch.Tensor]:
    """Diagnostic snapshot of pool and optimizer health (0-d tensors):
    masked quantiles of the activated opacity and world scale, the
    accumulated max screen radius, and per-group Adam effective step
    sizes lr·mean|m̂ / (√v̂ + ε) over alive rows.  The field's groups are
    named after the JAX pytree's top-level keys: ``grid``, ``mlp`` and
    ``empty_voxel``."""
    alive = state.pool.alive
    op = torch.sigmoid(state.pool.opacity[:, 0])
    ws = torch.exp(state.pool.scaling).amax(1)

    def mq(x, q):
        return torch.nanquantile(torch.where(alive, x, torch.nan), q)

    out = {
        "op_q01": mq(op, 0.01), "op_q50": mq(op, 0.5),
        "op_q99": mq(op, 0.99),
        "op_lo": ((op < 0.01) & alive).sum(dtype=torch.int32),
        "ws_q50": mq(ws, 0.5), "ws_q99": mq(ws, 0.99),
        "ws_max": torch.where(alive, ws, 0.0).amax(),
        "r2d_q99": mq(state.stats.max_radii2d, 0.99),
        "r2d_max": state.stats.max_radii2d.amax(),
    }
    lrs = lr_dict(state.step, opt, spatial_lr_scale)
    c = torch.clamp(state.adam.count.to(torch.float32), min=1.0)
    c1, c2 = 1 - torch.pow(B1, c), 1 - torch.pow(B2, c)

    def mag(m, v):
        return torch.abs(m / c1) / (torch.sqrt(v / c2) + EPS)

    for name, m in state.adam.mu["pool"].items():
        mask = alive.reshape((-1,) + (1,) * (m.dim() - 1))
        g = mag(m, state.adam.nu["pool"][name])
        mean = (torch.where(mask, g, 0.0).sum()
                / torch.clamp(mask.expand_as(g).sum(), min=1))
        out[f"estep_{name}"] = lrs[name] * mean
    sums: Dict[str, List[torch.Tensor]] = {}
    for name, m in state.adam.mu["deform"].items():
        top = name.split(".")[0]
        key = top if top in ("grid", "empty_voxel") else "mlp"
        sums.setdefault(key, []).append(mag(m, state.adam.nu["deform"][name]))
    for key, mags in sorted(sums.items()):
        tot = sum(x.sum() for x in mags)
        cnt = float(sum(x.numel() for x in mags))
        out[f"estep_{key}"] = (lrs["grid" if key == "grid" else "deformation"]
                               * tot / max(cnt, 1.0))
    out["lr_xyz"] = lrs["xyz"]
    out["lr_grid"] = lrs["grid"]
    out["lr_deformation"] = lrs["deformation"]
    return out


def densify_schedule(iteration: int, stage: str, opt: OptimizationParams
                     ) -> Tuple[float, float]:
    """(gradient, opacity) thresholds: constant in the coarse stage,
    annealed linearly over the fine stage and clamped past
    ``densify_until_iter`` (reference train.py:494-499)."""
    if stage == "coarse":
        return opt.densify_grad_threshold_coarse, opt.opacity_threshold_coarse
    frac = min(iteration / max(opt.densify_until_iter, 1), 1.0)
    op_thr = (opt.opacity_threshold_fine_init
              - frac * (opt.opacity_threshold_fine_init
                        - opt.opacity_threshold_fine_after))
    gr_thr = (opt.densify_grad_threshold_fine_init
              - frac * (opt.densify_grad_threshold_fine_init
                        - opt.densify_grad_threshold_after))
    return gr_thr, op_thr
