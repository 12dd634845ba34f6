"""Camera-batch data parallelism over ``torch.distributed`` (port of
``s3gaussian_tpu/parallel/data_parallel.py``).

Each rank holds a full replica of the train state and renders its own
same-time rig (``parallel_train_step_multicam``; its own camera,
``parallel_train_step``, is a rig of one at the unscaled learning
rates) with the single-device halves of the step
(``trainer.step_forward``, ``step_gradients``); the ranks then reduce,
as the JAX package's ``shard_map`` body does with ``psum`` / ``pmean``
/ ``pmax``:

  * the parameter gradients: the sum over ranks divided by the world size
    (the batched loss's gradient is the mean);
  * the statistics' tap term (``trainer.rig_stats``): with
    ``multicam_percam_stats`` the sum of every view's screen-gradient
    norms and the count of the views that saw each Gaussian, else the
    sum of the raw vectors;
  * the loss and each metric: the mean; the radii and visibility: the
    max; the four budget counters: the max (the worst rank, never
    averaged).

The span counters (``utils/spans.py``'s ``KEYS``) stay each rank's own;
the reductions are the step's ``allreduce`` span.

Every rank then applies the same reduced gradient to the same state
(``trainer.apply_param_update``, whose NaN watchdog reads the reduced
loss, so a NaN on one rank skips the step on all), and the replicas stay
bit-identical.  The reductions take two collectives a step: one flat
float32 SUM bucket (gradients, tap term, count, loss, metrics) and one
flat int32 MAX bucket (radii, visibility, counters), in the same order on
every rank; only ``all_reduce`` and ``broadcast`` are used, so the same
code runs on NCCL and on gloo.

``parallel_train_steps_scan`` and ``..._multicam`` (JAX's
``make_parallel_train_steps_scan[_multicam]``) run a block of N of these
steps: on the card as N replays of the step captured as one CUDA graph,
its two all-reduces inside (``train/graphs.py``), which needs NCCL; with
a gloo group on the card they raise, as gloo's collectives cannot be
captured.  On the CPU they loop the eager step.  ``make_mesh`` and the
``shard_camera_*`` helpers have no counterpart: the process group is the
mesh, and each rank keeps only its own cameras
(``multihost.local_batch_slice``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                         OptimizationParams, PipelineParams,
                                         RasterConfig)
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.parallel.multihost import rank_world
from s3gaussian_tpu_torch.train.checkpoints import state_tensors
from s3gaussian_tpu_torch.train.trainer import (TrainState,
                                                apply_param_update,
                                                rig_stats, scan_steps,
                                                step_forward,
                                                step_gradients, unscaled)
from s3gaussian_tpu_torch.utils import spans

COUNTERS = ("n_pairs", "overflow_rect", "overflow_visible", "overflow_pairs")
Terms = Dict[str, torch.Tensor]


def step_buckets(grads, tap_term: torch.Tensor,
                 vis_count: Optional[torch.Tensor], loss: torch.Tensor,
                 aux: Dict[str, Any]) -> Tuple[Terms, Terms]:
    """The terms one rank contributes to a step's reductions, as (SUM
    terms, MAX terms), each in the order every rank builds them: the
    gradients by sorted group and name, the tap term, ``vis_count``, the
    loss and the metrics by sorted name; the radii, the visibility and
    the counters."""
    sums = {f"grad.{g}.{k}": grads[g][k]
            for g in sorted(grads) for k in sorted(grads[g])}
    sums["tap"] = tap_term
    if vis_count is not None:
        sums["vis_count"] = vis_count
    sums["loss"] = loss
    sums.update({f"metric.{k}": aux["metrics"][k]
                 for k in sorted(aux["metrics"])})
    maxes = {"radii": aux["radii"], "visible": aux["visible"]}
    maxes.update({k: aux[k] for k in COUNTERS})
    return sums, maxes


def _all_reduce_flat(terms: Terms, dtype: torch.dtype, op) -> Terms:
    """All-reduce ``terms`` as one flat buffer of ``dtype``; each comes
    back in its own shape and dtype."""
    parts = list(terms.values())
    flat = torch.cat([t.reshape(-1).to(dtype) for t in parts])
    dist.all_reduce(flat, op=op)
    chunks = torch.split(flat, [t.numel() for t in parts])
    return {k: c.view(t.shape).to(t.dtype)
            for (k, t), c in zip(terms.items(), chunks)}


def all_reduce_buckets(sums: Terms, maxes: Terms) -> Tuple[Terms, Terms]:
    """The step's two collectives: ``sums`` summed as float32, ``maxes``
    max-reduced as int32 (booleans come back as "any")."""
    return (_all_reduce_flat(sums, torch.float32, dist.ReduceOp.SUM),
            _all_reduce_flat(maxes, torch.int32, dist.ReduceOp.MAX))


def reduced_update(state: TrainState, grads, tap_term: torch.Tensor,
                   vis_count: Optional[torch.Tensor], loss: torch.Tensor,
                   aux: Dict[str, Any], opt: OptimizationParams,
                   spatial_lr_scale: float
                   ) -> Tuple[TrainState, Dict[str, Any]]:
    """Reduce one rank's step terms over the process group and apply the
    update with the reduced ones, every learning rate scaled by
    ``opt.multicam_lr_scale``.  Returns the new state and the reduced
    aux (metrics, radii, visibility, counters and, with a count,
    ``vis_count``)."""
    spans.mark("allreduce")
    world = dist.get_world_size()
    sums, maxes = all_reduce_buckets(*step_buckets(
        grads, tap_term, vis_count, loss.detach(), aux))
    mean_grads = {g: {k: sums[f"grad.{g}.{k}"] / world for k in d}
                  for g, d in grads.items()}
    new_state = apply_param_update(
        state, mean_grads, sums["tap"], sums["loss"] / world,
        maxes["radii"], maxes["visible"], opt, spatial_lr_scale,
        lr_scale=opt.multicam_lr_scale, vis_count=sums.get("vis_count"))
    out = {"metrics": {k: sums[f"metric.{k}"] / world
                       for k in aux["metrics"]},
           "radii": maxes["radii"], "visible": maxes["visible"],
           **{k: maxes[k] for k in COUNTERS}}
    if "vis_count" in sums:
        out["vis_count"] = sums["vis_count"]
    return new_state, out


@spans.step
def parallel_train_step_multicam(state: TrainState,
                                 cameras: Sequence[Camera], stage: str,
                                 active_sh_degree: int,
                                 hp: ModelHiddenParams,
                                 opt: OptimizationParams,
                                 pipe: PipelineParams, cfg: RasterConfig,
                                 spatial_lr_scale: float, bg: torch.Tensor
                                 ) -> Tuple[TrainState, Dict[str, Any]]:
    """One data-parallel rig step: this rank's rig of same-time
    ``cameras`` (one field evaluation), its statistics terms as the rig
    step's (``trainer.rig_stats``), reduced over the process group, and
    the learning rates scaled by ``opt.multicam_lr_scale``."""
    loss, aux, tree, tap = step_forward(state, list(cameras), stage,
                                        active_sh_degree, hp, opt, pipe, cfg,
                                        bg)
    grads, tap_grad = step_gradients(loss, tree, tap)
    tap_term, vis_count = rig_stats(tap_grad, aux)
    return reduced_update(state, grads, tap_term, vis_count, loss, aux, opt,
                          spatial_lr_scale)


def parallel_train_step(state: TrainState, camera: Camera, stage: str,
                        active_sh_degree: int, hp: ModelHiddenParams,
                        opt: OptimizationParams, pipe: PipelineParams,
                        cfg: RasterConfig, spatial_lr_scale: float,
                        bg: torch.Tensor
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """One data-parallel step on this rank's ``camera``: the rig step on
    ``[camera]`` under ``trainer.unscaled(opt)``."""
    return parallel_train_step_multicam(state, [camera], stage,
                                        active_sh_degree, hp, unscaled(opt),
                                        pipe, cfg, spatial_lr_scale, bg)


def _capturable(state: TrainState) -> None:
    if (state.pool.xyz.device.type == "cuda"
            and dist.get_backend() != "nccl"):
        raise RuntimeError(
            f"a data-parallel block on the card captures its all-reduces "
            f"in a CUDA graph, which needs NCCL, not "
            f"{dist.get_backend()}: run steps one by one "
            f"(--steps_per_dispatch 1)")


def parallel_train_steps_scan(state: TrainState, cameras: Sequence[Camera],
                              stage: str, active_sh_degree: int,
                              hp: ModelHiddenParams, opt: OptimizationParams,
                              pipe: PipelineParams, cfg: RasterConfig,
                              spatial_lr_scale: float, bg: torch.Tensor,
                              marks: Optional[List[Any]] = None
                              ) -> Tuple[TrainState, Dict[str, Any]]:
    """``len(cameras)`` data-parallel steps in one dispatch, this rank's
    camera of each (JAX's ``make_parallel_train_steps_scan``): what as
    many ``parallel_train_step`` calls compute.  Returns the state and
    the reduced ``small_aux`` of every step, stacked."""
    _capturable(state)
    return scan_steps(parallel_train_step, state, list(cameras), stage,
                      active_sh_degree, hp, opt, pipe, cfg, spatial_lr_scale,
                      bg, marks)


def parallel_train_steps_scan_multicam(
        state: TrainState, rigs: Sequence[Sequence[Camera]], n_cams: int,
        stage: str, active_sh_degree: int, hp: ModelHiddenParams,
        opt: OptimizationParams, pipe: PipelineParams, cfg: RasterConfig,
        spatial_lr_scale: float, bg: torch.Tensor,
        marks: Optional[List[Any]] = None
        ) -> Tuple[TrainState, Dict[str, Any]]:
    """``len(rigs)`` data-parallel rig steps of ``n_cams`` cameras a rank
    in one dispatch (JAX's ``make_parallel_train_steps_scan_multicam``):
    what as many ``parallel_train_step_multicam`` calls compute."""
    rigs = [list(r) for r in rigs]
    if any(len(r) != n_cams for r in rigs):
        raise ValueError(f"rigs of {[len(r) for r in rigs]} cameras for "
                         f"n_cams={n_cams}")
    _capturable(state)
    return scan_steps(parallel_train_step_multicam, state, rigs, stage,
                      active_sh_degree, hp, opt, pipe, cfg, spatial_lr_scale,
                      bg, marks)


@torch.no_grad()
def replicate_state(state: TrainState) -> TrainState:
    """Overwrite every tensor of ``state`` (pool, alive mask, field, Adam
    moments and count, statistics, step, aabb, ``nan_skips``) with rank
    0's, in place: one broadcast per dtype, the tensors in sorted name
    order.  A no-op for one process."""
    if rank_world()[1] == 1:
        return state
    flat = state_tensors(state)
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for name in sorted(flat):
        groups.setdefault(flat[name].dtype, []).append(flat[name])
    for dtype in sorted(groups, key=str):
        parts = groups[dtype]
        wire = torch.uint8 if dtype == torch.bool else dtype
        buf = torch.cat([t.reshape(-1).to(wire) for t in parts])
        dist.broadcast(buf, src=0)
        for t, c in zip(parts, torch.split(buf, [t.numel() for t in parts])):
            t.copy_(c.view(t.shape).to(dtype))
    return state


@torch.no_grad()
def replica_checksum(state: TrainState) -> torch.Tensor:
    """A 0-d int64 checksum of ``state``'s bits: over its tensors in
    sorted name order, the (1-based) position times the sum of the
    tensor's bit patterns, floats read as int32 words (wrapping)."""
    flat = state_tensors(state)
    total = 0
    for i, name in enumerate(sorted(flat)):
        t = flat[name]
        bits = t.view(torch.int32) if t.is_floating_point() else t
        total = total + bits.to(torch.int64).sum() * (i + 1)
    return total


def replica_checksum_range(state: TrainState) -> Tuple[int, int]:
    """(MIN, MAX) of ``replica_checksum`` over the ranks: the replicas
    agree when the two are equal."""
    c = replica_checksum(state)
    lo, hi = c.clone(), c.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return int(lo), int(hi)
