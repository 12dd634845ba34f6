"""The train step captured as one CUDA graph and replayed N times a
dispatch (the counterpart of the JAX package's ``jax.jit`` of
``_train_step_impl``, which ``train_steps_scan`` runs N times under one
``lax.scan``).

An eager step issues thousands of kernel launches from the host; a
replay issues one graph launch.  ``StepGraph`` captures one step for a
key: the step function and its stage, one camera or a rig of B, the
image size, which supervision maps the cameras carry, the pool's
capacity and the settings.  What may differ between the steps of a
stage reaches the captured step as a tensor at a fixed address:

  * the cameras: static buffers of every tensor a camera carries
    (transforms, centre, time, field-of-view tangents, image, depth,
    feature map, masks), filled by stream-ordered copies before each
    replay;
  * the active SH degree, a 0-d int32 tensor (the SH colours band-mask a
    full evaluation, ``ops/sh.py::eval_sh_dynamic``), so one capture
    serves a stage as one compile does in JAX;
  * the background colour;
  * the train state: the step writes every output into the state's own
    tensors (``trainer.apply_param_update``), so the next replay reads
    what the last one wrote.  The first state given is adopted as the
    static one; ``load`` copies a later state into it tensor by tensor,
    where the two differ (a densify, an opacity reset, a new stage's
    moments, a checkpoint restore), which the pool's fixed capacity
    makes possible without a recapture.

The evaluation sweep's renders are captured the same way
(``RenderGraph``, ``render_graph``): static camera buffers, the other
inputs that differ between replays (the flow colours) as static
buffers, outputs at fixed addresses, the same one-graph slot.

A capture first runs the step once on a copy of the state, on the side
stream the capture then uses, as PyTorch asks of a whole-step capture:
lazy initialisations (library handles and workspaces, constant caches,
the NCCL communicator) happen there, and the state keeps its values.  A
failed capture raises.  Only one graph is held at a time: a new key
frees the old graph and its private memory pool (the stage only
advances), and ``release`` frees it before the evaluation sweep.

The kernel launches made inside a capture (compositors, segment sums,
span marks) are counted once per replay
(``ops/tile_kernels.py::count_replay``).  Data-parallel steps capture
their all-reduces, which NCCL supports and gloo does not.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                         OptimizationParams, PipelineParams,
                                         RasterConfig)
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.train.checkpoints import state_tensors
from s3gaussian_tpu_torch.train.trainer import (TrainState, small_aux,
                                                stack_aux)
from s3gaussian_tpu_torch.utils import spans

Step = Callable[..., Tuple[TrainState, Dict[str, Any]]]


def camera_tensors(cam: Camera) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)
            if isinstance(getattr(cam, f.name), torch.Tensor)}


def _cameras(view) -> List[Camera]:
    return list(view) if isinstance(view, (list, tuple)) else [view]


def graph_key(step: Step, state: TrainState, view, stage: str,
              hp: ModelHiddenParams, opt: OptimizationParams,
              pipe: PipelineParams, cfg: RasterConfig,
              spatial_lr_scale: float) -> tuple:
    """What a captured step is specialised on; everything else is an
    input of the graph."""
    cams = _cameras(view)
    return (step.__module__, step.__qualname__, stage,
            isinstance(view, (list, tuple)), len(cams),
            cams[0].image_height, cams[0].image_width,
            tuple(tuple(sorted(camera_tensors(c))) for c in cams),
            state.pool.capacity, str(state.pool.xyz.device), repr(hp),
            repr(opt), repr(pipe), repr(cfg), float(spatial_lr_scale))


# one side stream per device for every capture: cuBLAS keeps a workspace
# for each stream it ran on, so a new stream per capture held device
# memory that grew with every capture of a process
_side_streams: Dict[int, torch.cuda.Stream] = {}


def side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream every capture on ``dev`` runs on."""
    index = torch.device(dev).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


def capture(dev: torch.device, warmup: Callable[[], Any],
            body: Callable[[], Any]):
    """``body`` captured as one CUDA graph on the device's side stream, after
    ``warmup`` ran there once (lazy initialisations: library handles and
    workspaces, constant caches, an NCCL communicator).  Returns (graph,
    body's outputs, warm-up ms, capture ms, compositor launches
    captured (forward, backward), segment-sum and span-mark launches
    captured); the two times are the host spans ``graph.warmup`` and
    ``graph.capture`` (``utils/spans.py``)."""
    # a collective's watchdog queries events from its own thread while
    # the capture runs: only this thread's calls must be capture-safe
    mode = ("thread_local" if torch.distributed.is_available()
            and torch.distributed.is_initialized() else "global")
    side = side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with spans.host("graph.warmup") as warm:
        with torch.cuda.stream(side):
            warmup()
        side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = list(tk.captured) + [tk.seg_captured, tk.mark_captured]
    with spans.host("graph.capture") as cap:
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            out = body()
        torch.cuda.synchronize(dev)
    return (graph, out, warm.ms, cap.ms,
            (tk.captured[0] - before[0], tk.captured[1] - before[1]),
            tk.seg_captured - before[2], tk.mark_captured - before[3])


def static_cameras(cams: Sequence[Camera], dev: torch.device
                   ) -> List[Camera]:
    """Copies of ``cams`` whose tensors are the graph's buffers on
    ``dev``."""
    return [dataclasses.replace(c, **{
        k: v.to(dev).clone() for k, v in camera_tensors(c).items()})
        for c in cams]


def fill_cameras(static: Sequence[Camera], cams: Sequence[Camera]) -> None:
    """Stream-ordered copies of ``cams``' tensors into the buffers of
    ``static``."""
    if len(cams) != len(static):
        raise ValueError(f"{len(cams)} cameras for a graph of "
                         f"{len(static)}")
    for buf_cam, cam in zip(static, cams):
        src = camera_tensors(cam)
        for name, buf in camera_tensors(buf_cam).items():
            buf.copy_(src[name], non_blocking=True)


class StepGraph:
    """One step of ``step`` captured as a CUDA graph (see the module's
    docstring).  ``run(view, active_sh_degree)`` replays it on ``view``
    (a camera, or a rig as a list) and returns its outputs: the step's
    ``small_aux`` and its radii and visibility, in the graph's own
    tensors, overwritten by the next replay."""

    def __init__(self, key: tuple, step: Step, state: TrainState, view,
                 stage: str, hp: ModelHiddenParams, opt: OptimizationParams,
                 pipe: PipelineParams, cfg: RasterConfig,
                 spatial_lr_scale: float, bg: torch.Tensor):
        self.key = key
        self.state = state
        dev = state.pool.xyz.device
        self.rig = isinstance(view, (list, tuple))
        self.cams = static_cameras(_cameras(view), dev)
        self.sh = torch.zeros((), dtype=torch.int32, device=dev)
        self.bg = bg.to(dev).clone()
        self.replays = 0

        def body(st: TrainState):
            st, aux = step(st, self.cams if self.rig else self.cams[0],
                           stage, self.sh, hp, opt, pipe, cfg,
                           spatial_lr_scale, self.bg)
            return {**small_aux(aux), "radii": aux["radii"],
                    "visible": aux["visible"]}

        def warmup():
            scratch = clone_state(state)
            body(scratch)

        (self.graph, self.out, self.warmup_ms, self.capture_ms,
         self.launches, self.seg_launches, self.mark_launches) = capture(
            dev, warmup, lambda: body(state))

    def load(self, state: TrainState) -> TrainState:
        """``load_state`` into this graph's static state."""
        return load_state(self.state, state)

    def run(self, view, active_sh_degree: int | torch.Tensor,
            bg: torch.Tensor) -> Dict[str, Any]:
        """Fill the camera buffers, the degree and the background, then
        replay the step once."""
        fill_cameras(self.cams, _cameras(view))
        if isinstance(active_sh_degree, torch.Tensor):
            self.sh.copy_(active_sh_degree)
        else:
            self.sh.fill_(int(active_sh_degree))
        self.bg.copy_(bg, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        tk.count_replay(*self.launches, self.seg_launches,
                        self.mark_launches)
        return self.out


def load_state(static: TrainState, state: TrainState) -> TrainState:
    """Copy ``state`` into ``static`` where a tensor of it is not already
    the static one (by address); returns ``static``.  Raises on a state
    of other tensors or shapes."""
    if state is static:
        return static
    mine, theirs = state_tensors(static), state_tensors(state)
    if mine.keys() != theirs.keys():
        raise ValueError("a state of another model: "
                         f"{sorted(set(mine) ^ set(theirs))[:4]}")
    with torch.no_grad():
        for name, t in mine.items():
            src = theirs[name]
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"{name}: {src.dtype}{tuple(src.shape)} "
                                 f"for a graph of {t.dtype}{tuple(t.shape)}")
            if src.data_ptr() != t.data_ptr():
                t.copy_(src)
    return static


class RenderGraph:
    """A render of a camera or a rig captured as one CUDA graph (the
    counterpart of the JAX sweep's ``_jit_render`` and ``_jit_render_mc``
    programs): ``fn(cams, **inputs)`` returns a dict of tensors.
    ``run(cams, **inputs)`` copies the cameras' tensors and the inputs
    into the graph's buffers, replays, and returns the outputs, the
    graph's own tensors, which the next replay overwrites.  Whatever
    ``fn`` reads besides (the pool, the field, the aabb) is read where it
    was at capture."""

    def __init__(self, key: tuple, fn: Callable[..., Dict[str, Any]],
                 cams: Sequence[Camera], inputs: Dict[str, torch.Tensor]):
        dev = cams[0].world_view.device
        self.key = key
        self.cams = static_cameras(cams, dev)
        self.inputs = {k: v.to(dev).clone() for k, v in inputs.items()}
        self.replays = 0

        def body():
            return fn(self.cams, **self.inputs)

        (self.graph, self.out, self.warmup_ms, self.capture_ms,
         self.launches, self.seg_launches, self.mark_launches) = capture(
             dev, body, body)

    def run(self, cams: Sequence[Camera],
            **inputs: torch.Tensor) -> Dict[str, Any]:
        fill_cameras(self.cams, cams)
        for k, v in inputs.items():
            self.inputs[k].copy_(v, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        tk.count_replay(*self.launches, self.seg_launches,
                        self.mark_launches)
        return self.out


def render_graph(key: tuple, fn: Callable[..., Dict[str, Any]],
                 cams: Sequence[Camera], inputs: Dict[str, torch.Tensor]
                 ) -> RenderGraph:
    """The held graph when its key is ``key``, else ``fn`` captured on
    ``cams`` and ``inputs`` in its place."""
    global _current
    if _current is None or _current.key != key:
        release()
        _current = RenderGraph(key, fn, cams, inputs)
    return _current


_current: Optional[StepGraph | RenderGraph] = None


def current() -> Optional[StepGraph | RenderGraph]:
    """The graph held now, or None."""
    return _current


def release() -> None:
    """Free the held graph and its private memory pool."""
    global _current
    _current = None


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` whose tensors are new (the warm-up's)."""
    adam = dataclasses.replace(
        state.adam,
        mu={g: {k: v.clone() for k, v in d.items()}
            for g, d in state.adam.mu.items()},
        nu={g: {k: v.clone() for k, v in d.items()}
            for g, d in state.adam.nu.items()},
        count=state.adam.count.clone())
    pool = dataclasses.replace(state.pool, **{
        f.name: getattr(state.pool, f.name).clone()
        for f in dataclasses.fields(state.pool)})
    stats = dataclasses.replace(state.stats, **{
        f.name: getattr(state.stats, f.name).clone()
        for f in dataclasses.fields(state.stats)})
    return dataclasses.replace(state, pool=pool, deform=copy.deepcopy(
        state.deform), adam=adam, stats=stats, step=state.step.clone(),
        aabb=state.aabb.clone(), nan_skips=state.nan_skips.clone())


def replay_steps(step: Step, state: TrainState, views: Sequence, stage: str,
                 active_sh_degree: int | torch.Tensor,
                 hp: ModelHiddenParams, opt: OptimizationParams,
                 pipe: PipelineParams, cfg: RasterConfig,
                 spatial_lr_scale: float, bg: torch.Tensor,
                 marks: Optional[List[Any]] = None
                 ) -> Tuple[TrainState, Dict[str, Any]]:
    """``len(views)`` steps of ``step`` as replays of its graph, which is
    captured first where the held one has another key.  The state is
    loaded into the graph's static state; each step's ``small_aux`` is
    copied on the device, with no host read in between.  Returns
    the static state and the stacked ``small_aux``.  ``marks``, when
    given, receives a CUDA event recorded before the first replay and
    after each."""
    global _current
    if not views:
        raise ValueError("a block of no steps")
    key = graph_key(step, state, views[0], stage, hp, opt, pipe, cfg,
                    spatial_lr_scale)
    if _current is None or _current.key != key:
        release()
        _current = StepGraph(key, step, state, views[0], stage, hp, opt,
                             pipe, cfg, spatial_lr_scale, bg)
    g = _current
    state = g.load(state)
    rows = []

    def mark():
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    mark()
    for view in views:
        out = g.run(view, active_sh_degree, bg)
        # copies on the device: the next replay overwrites the outputs
        rows.append({"metrics": {k: v.clone()
                                 for k, v in out["metrics"].items()},
                     **{k: v.clone() for k, v in out.items()
                        if k not in ("metrics", "radii", "visible")}})
        mark()
    return state, stack_aux(rows)
