"""Mixes of kind ``train``: the CLI's fine-stage inner loop.

Set-up builds one train state from the seed's clip, as the CLI builds
it (``create_from_pcd``, the seeded field, ``init_state``, the
auto-sized render budget), and drives it through the window's own call,
``trainer.train_steps_scan`` or ``train_steps_scan_multicam`` (on the
card replays of the step captured as one CUDA graph): a block of one
step, then one of two (the compared steps: the first moment after the
first step, the change after the third), then the rest of a block.
The window then runs blocks of ``steps_per_dispatch`` steps until
``--seconds`` pass, each step on the next view or rig of the seeded
order, reading each block's counters one block behind.  Once the window
has closed and the peak is read, the program's state is freed and the
plain reference follows the first three steps.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.frozen import compare, flops, reference
from benchmark.harness import clip as clipgen
from benchmark.harness import trace as tracing


def _program_settings(config: Dict):
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams, RasterConfig)
    return (ModelHiddenParams(**config["model"]),
            OptimizationParams(**config["optimization"]), PipelineParams(),
            RasterConfig(**config["raster"]))


def _program_cameras(clip, config: Dict) -> List:
    from s3gaussian_tpu_torch.data.cameras import Camera
    fovx, fovy = clipgen.fov(config["clip"])
    c = config["clip"]
    return [Camera(world_view=v["world_view"], full_proj=v["full_proj"],
                   campos=v["campos"], time=v["time"], fovx=fovx, fovy=fovy,
                   image_height=c["height"], image_width=c["width"],
                   image=v["image"], depth_map=v["depth_map"],
                   feat_map=v["feat_map"], dynamic_mask=v["dynamic_mask"],
                   uid=i, cam_idx=v["cam"], frame_idx=v["frame"])
            for i, v in enumerate(clip.views)]


def _host_read(aux: Dict) -> Dict[str, List[float]]:
    """A block's counters on the host, in one copy."""
    keys = ("n_pairs", "overflow_rect", "overflow_visible", "overflow_pairs")
    rows = [aux[k].to(torch.float64) for k in keys]
    rows.append(aux["metrics"]["loss"].to(torch.float64))
    got = torch.stack(rows).cpu().numpy()
    return dict(zip(keys + ("loss",), got.tolist()))


def _extend(counters: Dict[str, List[float]], aux: Dict) -> None:
    for k, v in _host_read(aux).items():
        counters.setdefault(k, []).extend(v)


def _failed(counters: Dict[str, List[float]]) -> int:
    """Steps with a non-finite loss or a dropped visible slot or pair:
    failed, never faster."""
    return sum(1 for i, loss in enumerate(counters["loss"])
               if not math.isfinite(loss)
               or counters["overflow_visible"][i] != 0
               or counters["overflow_pairs"][i] != 0)


def run(ctx: Dict) -> Dict:
    """One run of a train cell; returns the harness's result pieces."""
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.ops import tile_kernels as tk
    from s3gaussian_tpu_torch.train import trainer
    from s3gaussian_tpu_torch.train_cli import auto_max_visible

    config, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["dev"]
    log = ctx["log"]
    on_card = dev.type == "cuda"
    if on_card:
        tk.build()
    clip = clipgen.make_clip(config, seed, dev)
    hp, opt, pipe, cfg = _program_settings(config)
    points = clip.points.cpu().numpy()
    pool = create_from_pcd(points, clip.colors.cpu().numpy(),
                           config["capacity"], config["sh_degree"],
                           device=dev)
    field = DeformationField(hp, torch.Generator().manual_seed(
        int(seed) % (1 << 63)), dev)
    state = trainer.init_state(pool, field, clip.aabb)
    cams = _program_cameras(clip, config)
    rig = config["multicam"] > 1
    if cfg.max_visible == 0:
        cfg.max_visible = auto_max_visible(
            points, [cams[i] for u in clip.train_units for i in u],
            config["capacity"], group_by_frame=rig)
    bg = torch.zeros(3, device=dev)
    common = (config["stage"], config["sh_degree"], hp, opt, pipe, cfg,
              clip.spatial_lr_scale, bg)
    order = clipgen.unit_order(len(clip.train_units), seed)
    used: List[int] = []          # the train unit of every step, in order

    def block(n: int):
        used.extend(next(order) for _ in range(n))
        views = [[cams[i] for i in clip.train_units[u]] for u in used[-n:]]
        if rig:
            return trainer.train_steps_scan_multicam(
                state, views, config["multicam"], *common)
        return trainer.train_steps_scan(state, [v[0] for v in views],
                                        *common)

    # the compared steps, through the window's own call
    tree0 = compare.leaves(state.pool.param_dict(),
                           state.deform.named_parameters())
    start = {k: v.detach().to("cpu", copy=True) for k, v in tree0.items()}
    warm: Dict[str, List[float]] = {}
    state, aux = block(1)
    _extend(warm, aux)
    grad = compare.first_grad_norms(compare.leaves(
        state.adam.mu["pool"], state.adam.mu["deform"].items()))
    state, aux = block(mix["check_steps"] - 1)
    _extend(warm, aux)
    delta = compare.change_norms(start, compare.leaves(
        state.pool.param_dict(), state.deform.named_parameters()))
    del start
    prog = {"losses": list(warm["loss"]), "grad": grad, "delta": delta}
    spd = mix["steps_per_dispatch"]
    state, aux = block(spd - mix["check_steps"])
    _extend(warm, aux)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = ctx["process_age"]()
    log(f"set-up {setup_s:.3f} s: {config['num_pts']} points in "
        f"{config['capacity']} rows, max_visible {cfg.max_visible}, "
        f"pair budget {cfg.pair_budget}, spatial_lr_scale "
        f"{clip.spatial_lr_scale:.6f}, warm-up n_pairs "
        f"{[int(x) for x in warm['n_pairs']]}")

    # the window
    counters: Dict[str, List[float]] = {}
    steps = 0
    prof = tracing.start() if ctx["trace"] else None
    max_blocks = mix["trace_max_blocks"] if ctx["trace"] else math.inf
    pending = None
    blocks = 0
    reads: List[float] = []       # host clock after each block's read
    t0 = time.perf_counter()
    with tracing.window(prof):
        while True:
            state, aux = block(spd)
            blocks += 1
            steps += spd
            if pending is not None:
                _extend(counters, pending)
                reads.append(time.perf_counter() - t0)
            pending = aux
            if (time.perf_counter() - t0 >= ctx["seconds"]
                    or blocks >= max_blocks):
                break
        _extend(counters, pending)
        if on_card:
            torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n_cams = config["multicam"] if rig else 1
    views = steps * n_cams
    failed = _failed(counters) + _failed(warm)
    log(f"window: {blocks} blocks in {window_s:.6f} s; host clock at each "
        f"block's read (one behind) {[round(r, 4) for r in reads]}")
    pair_report(ctx, counters, n_cams, state, on_card)

    layer: Dict = {}
    if ctx["trace"]:
        layer = tracing.summary(prof, ctx)
        window_units = used[-steps:]
        layer.update(work_yardstick(ctx, clip, state, cfg, window_units,
                                    counters, steps, n_cams))
    # free the program's state before the reference runs
    del state, aux, pending, pool, field, tree0
    if on_card:
        from s3gaussian_tpu_torch.train import graphs
        graphs.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    seg_calls: List = []
    t_ref = time.perf_counter()
    check_units = [clip.train_units[u] for u in used[:mix["check_steps"]]]
    ref = reference.run_steps(clip, config, seed, check_units, dev,
                              segment_sums=seg_calls if ctx["trace"]
                              else None)
    log(f"reference: {mix['check_steps']} steps in "
        f"{time.perf_counter() - t_ref:.3f} s, max_visible "
        f"{ref['max_visible']} (program {cfg.max_visible})")
    numbers = compare.train_numbers(prog, ref)
    if ref["max_visible"] != cfg.max_visible:
        failed += 1
    if ctx["trace"]:
        layer["segment_sum_least_s"] = steps * flops.least_s(
            0, flops.segment_sum_bytes(seg_calls))
    return {"setup_s": setup_s, "window_s": window_s, "views": views,
            "rates": {"train_views_per_s": views / window_s},
            "steps": steps, "peak_bytes": peak, "failed": failed,
            "attempted": steps, "numbers": numbers, "layer": layer,
            "program": prog, "reference": ref, "check_units": check_units,
            "losses": (prog["losses"], ref["losses"])}


def pair_report(ctx: Dict, counters: Dict, n_cams: int, state,
                on_card: bool) -> None:
    """The pair-load report (not a metric): n_pairs per view over the
    window and the last step's screen radii of the visible rows."""
    per_view = [p / n_cams for p in counters["n_pairs"]]
    line = (f"pair load: n_pairs per view min {min(per_view):.1f} median "
            f"{statistics.median(per_view):.1f} max {max(per_view):.1f} over "
            f"{len(per_view)} steps; overflow visible "
            f"{int(max(counters['overflow_visible']))} pairs "
            f"{int(max(counters['overflow_pairs']))} rect "
            f"{int(max(counters['overflow_rect']))}")
    if on_card:
        from s3gaussian_tpu_torch.train import graphs
        out = graphs.current().out
        r = out["radii"].to(torch.float32)[out["visible"]]
        if r.numel():
            q = torch.quantile(r[:1 << 24], torch.tensor(
                [0.5, 0.9, 0.99], device=r.device)).tolist()
            line += (f"; screen radius (px) of the {r.numel()} visible rows "
                     f"p50 {q[0]:.2f} p90 {q[1]:.2f} p99 {q[2]:.2f} max "
                     f"{float(r.max()):.2f}")
    ctx["log"](line)


def work_yardstick(ctx: Dict, clip, state, cfg, window_units: List[int],
                   counters: Dict, steps: int, n_cams: int) -> Dict:
    """The work the traced window's steps require (frozen counters): the
    compositors' least time and operations from the work counts of a
    seeded sample of its views, as a ratio per pair scaled to the
    window's pairs, and the rest of the step from shapes."""
    from benchmark.frozen import counts as wcount
    config = ctx["config"]
    rng = np.random.default_rng([int(ctx["seed"]) % (1 << 63), 2])
    sample = [int(u) for u in rng.choice(
        sorted(set(window_units)), ctx["mix"]["work_count_views"],
        replace=False)]
    calls = wcount.sample_calls(clip, config, state, cfg, sample)
    pairs = sum(c["n_pairs"] for c in calls)
    per_view_calls = len(calls) / (len(sample) * n_cams)
    window_pairs = sum(counters["n_pairs"]) * per_view_calls
    bwd_least = sum(c["bwd_least_s"] for c in calls) / pairs
    comp_ops = sum(c["fwd_ops"] + c["bwd_ops"] for c in calls) / pairs
    rows = wcount.frustum_rows(clip, config, window_units)
    c = config["clip"]
    grid_params = sum(p.numel() for n, p in state.deform.named_parameters()
                      if n.startswith("grid."))
    n_params = (int(state.pool.n_alive) * 59
                + sum(p.numel() for p in state.deform.parameters()))
    field_rows = (rows["rig_union_mean"] if config["multicam"] > 1
                  else int(state.pool.n_alive))
    per_step = flops.train_step(config["model"], field_rows,
                                rows["view_mean"] * n_cams,
                                c["height"] * c["width"] * n_cams, n_params,
                                [], grid_params)
    ctx["log"](f"work yardstick: sample steps' units {sample}, {len(calls)} "
               f"compositor passes, {pairs} pairs; per pair "
               f"{comp_ops:.3f} compositor operations, backward least "
               f"{bwd_least * 1e9:.6f} ns; field rows {field_rows:.1f}, "
               f"projected rows a view {rows['view_mean']:.1f}, "
               f"{per_step} other operations a step")
    return {"flops": per_step * steps + comp_ops * window_pairs,
            "composite_bwd_least_s": bwd_least * window_pairs,
            "pairs_per_view": sum(counters["n_pairs"]) / (steps * n_cams)}
