"""Training CLI of the port (counterpart of the repository's ``train.py``):

    python -m s3gaussian_tpu_torch.train_cli -s <waymo_clip> \\
        --model_path out/ [--configs arguments/nvs.py] \\
        [--start_checkpoint out/chkpnt_coarse_5000] \\
        [--prior_checkpoint out_prev/chkpnt_fine_50000]
    python -m s3gaussian_tpu_torch.train_cli -s <waymo_clip> \\
        --model_path out/ --eval_only

It reads the clip, builds the pool from its LiDAR points and trains the
two stages (coarse, then fine) on the card, one camera per step or, with
``--multicam B``, a rig of B same-time cameras per step, with
density control every ``densification_interval`` steps, the opacity
reset, ``logger.json`` telemetry (every 100 steps, or ``S3G_LOG_EVERY``),
training snapshots, checkpoints, a final PLY and the evaluation sweep
(``eval/video.py::do_evaluation``: at iteration 30000 and after
training, unless ``--skip_final_eval``).  ``--eval_only`` restores the
latest checkpoint under ``--model_path`` and runs only the sweep.  The
flags are those of ``train.py`` but the TPU-only fields of the config
groups.

``--steps_per_dispatch N`` (default 10) follows ``train.py``'s rule: a
block of N steps runs in one dispatch (``trainer.train_steps_scan``,
``..._multicam`` or their data-parallel forms) unless a host event
(log, densify, opacity reset, checkpoint, snapshot, evaluation, the end
of ``--bench_iters``) falls after one of its first N-1 steps or an SH
degree bump inside it; the logger then reads the block's last step.  On
the card a block is N replays of the step captured as one CUDA graph,
and a step outside a block replays the same graph; on the CPU both are
eager steps.

``--batch_size B > 1`` trains data-parallel, one process per device on
``torch.distributed`` (``parallel/``): each of the B ranks takes one
camera of the batch, or one rig with ``--multicam``, every rank pops the
same seeded batch and keeps its own row, and only rank 0 writes files:

    torchrun --nproc_per_node B -m s3gaussian_tpu_torch.train_cli \\
        -s <waymo_clip> --model_path out/ --batch_size B

Before it reads the scene it refuses a single process that sees at least
B cards (it names the torchrun command), and a process group whose world
size is not B.  With fewer devices than B it prints ``train.py``'s note
and trains with batch size 1, as ``train.py`` does.  Training snapshots
are skipped with more than one rank.  On the card a data-parallel block
captures its all-reduces, which needs NCCL: with a gloo group there it
refuses ``--steps_per_dispatch`` above 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from s3gaussian_tpu_torch.config import (FieldParams, ModelHiddenParams,
                                         ModelParams, OptimizationParams,
                                         PipelineParams, RasterConfig,
                                         add_group_args, apply_config_file,
                                         extract_group)
from s3gaussian_tpu_torch.data.cameras import write_cameras_json
from s3gaussian_tpu_torch.data.scene import load_scene
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.eval.video import do_evaluation
from s3gaussian_tpu_torch.models.fields import Field, build_field
from s3gaussian_tpu_torch.parallel.data_parallel import (
    parallel_train_step, parallel_train_step_multicam,
    parallel_train_steps_scan, parallel_train_steps_scan_multicam,
    replicate_state)
from s3gaussian_tpu_torch.parallel.multihost import (init_multihost,
                                                     is_primary,
                                                     local_batch_slice,
                                                     sync_hosts)
from s3gaussian_tpu_torch.train import checkpoints as ckpt
from s3gaussian_tpu_torch.train import graphs
from s3gaussian_tpu_torch.train.trainer import (densify_schedule,
                                                densify_step, init_state,
                                                opacity_reset_step,
                                                last_step, probe_pool,
                                                reinit_optimizer,
                                                small_aux, train_step,
                                                train_step_multicam,
                                                train_steps_scan,
                                                train_steps_scan_multicam)
from s3gaussian_tpu_torch.utils import spans

MID_EVAL_ITER = 30000


@spans.host("budget")
def auto_max_visible(points, cams, capacity: int, growth: float = 2.0,
                     lane: int = 2048, group_by_frame: bool = False) -> int:
    """``--max_visible 0``: ``growth`` x the largest per-camera count of
    init points in the frustum (depth > 0.2, the projector's 1.3·tan(fov/2)
    clamp as its edge), lane-rounded and clamped to the pool capacity.
    With ``group_by_frame`` (rig steps) the count is that of the union
    of each frame's cameras, as one cull serves the whole rig.  The
    host span ``budget``."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    best = 0
    union = {}
    for cam in cams:
        view = cam.world_view.cpu().numpy()
        p = pts @ view[:3, :3] + view[3, :3]
        z = p[:, 2]
        tx = 1.3 * np.tan(0.5 * cam.fovx)
        ty = 1.3 * np.tan(0.5 * cam.fovy)
        vis = (z > 0.2) & (np.abs(p[:, 0]) < tx * z) & (np.abs(p[:, 1]) < ty * z)
        if group_by_frame:
            k = int(cam.frame_idx)
            union[k] = vis if k not in union else union[k] | vis
        else:
            best = max(best, int(vis.sum()))
    if group_by_frame:
        best = max(int(v.sum()) for v in union.values())
    nr = int(np.ceil(growth * best / lane)) * lane
    return max(lane, min(nr, capacity))


def group_by_time(cams) -> list:
    """Indices of the cameras grouped by time (to 1e-6), in first-seen
    order: the rigs of ``--multicam`` (train.py's ``group_by_time``)."""
    by_t = {}
    for i, c in enumerate(cams):
        by_t.setdefault(round(float(c.time), 6), []).append(i)
    return list(by_t.values())


def visible_devices(device: torch.device) -> int:
    """The cards one process sees: the CUDA cards, or 1."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_deformation(hyper: ModelHiddenParams, field: FieldParams, seed: int,
                     device: torch.device) -> Field:
    """The deformation field ``field`` names, its initial weights drawn
    from ``seed``."""
    return build_field(hyper, field, torch.Generator().manual_seed(seed),
                       device)


def parallel_refusal(batch_size: int, world: int,
                     visible: int) -> Optional[str]:
    """Why a ``--batch_size`` run cannot start, or None.  The port runs
    one process per device, so a single process that sees ``batch_size``
    cards would train at batch size 1 where ``train.py`` uses the cards;
    a process group must hold one rank per camera of the batch."""
    if world == 1 and 1 < batch_size <= visible:
        return (f"--batch_size {batch_size} with {visible} devices in one "
                f"process: the port runs one process per device; launch "
                f"torchrun --nproc_per_node {batch_size} -m "
                f"s3gaussian_tpu_torch.train_cli ... --batch_size "
                f"{batch_size}")
    if world > 1 and world != batch_size:
        return (f"{world} ranks for --batch_size {batch_size}: a data-"
                f"parallel run takes one rank per camera of the batch")
    return None


def dispatch_refusal(steps_per_dispatch: int, device: torch.device,
                     backend: Optional[str]) -> Optional[str]:
    """Why ``--steps_per_dispatch`` cannot run, or None: on the card a
    block of data-parallel steps is a captured CUDA graph with its
    all-reduces inside, which NCCL can be captured into and gloo
    cannot (``backend`` is the process group's, None without one)."""
    if (steps_per_dispatch > 1 and device.type == "cuda"
            and backend not in (None, "nccl")):
        return (f"--steps_per_dispatch {steps_per_dispatch} replays the "
                f"step as a CUDA graph, whose all-reduces {backend} cannot "
                f"be captured into: pass --steps_per_dispatch 1, or run "
                f"on NCCL")
    return None


def snapshot_due(iteration: int) -> bool:
    """The training-snapshot cadence (reference train.py:477-487)."""
    return ((iteration < 10000 and iteration % 1000 == 999)
            or (iteration < 30000 and iteration % 2000 == 1999)
            or iteration % 3000 == 2999)


def main(argv=None, device: str = "cuda"):
    """Run the CLI on ``device``; returns the final train state."""
    parser = argparse.ArgumentParser(description="S3Gaussian training "
                                     "(PyTorch port)")
    add_group_args(parser, ModelParams, "Loading Parameters")
    add_group_args(parser, OptimizationParams, "Optimization Parameters")
    add_group_args(parser, PipelineParams, "Pipeline Parameters")
    add_group_args(parser, ModelHiddenParams, "ModelHiddenParams")
    add_group_args(parser, RasterConfig, "Rasterizer")
    add_group_args(parser, FieldParams, "Deformation field")
    parser.add_argument("--seed", type=int, default=6666)
    parser.add_argument("--expname", type=str, default="waymo")
    parser.add_argument("--configs", type=str, default="")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--skip_final_eval", action="store_true",
                        help="skip the end-of-training eval sweep")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[30000, 50000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--prior_checkpoint", type=str, default=None)
    parser.add_argument("--bench_iters", type=int, default=0,
                        help="run only N timed iterations per stage")
    parser.add_argument("--steps_per_dispatch", type=int, default=10,
                        help="run up to N train steps per dispatch, on "
                             "the card as replays of one CUDA graph "
                             "(1 = step-by-step)")
    args = parser.parse_args(argv)

    model = extract_group(ModelParams, args)
    opt = extract_group(OptimizationParams, args)
    pipe = extract_group(PipelineParams, args)
    hyper = extract_group(ModelHiddenParams, args)
    cfg = extract_group(RasterConfig, args)
    field = extract_group(FieldParams, args)
    if args.configs:
        apply_config_file(args.configs, model, pipe, opt, hyper, cfg, field)
    # one process per device: the ranks of the process group are the
    # devices of a data-parallel run (a no-op (0, 1) without a group)
    rank, world = init_multihost(device=device)
    why = parallel_refusal(opt.batch_size, world,
                           visible_devices(torch.device(device)))
    if why:
        raise SystemExit(f"train_cli: {why}")
    backend = dist.get_backend() if world > 1 else None
    why = dispatch_refusal(args.steps_per_dispatch, torch.device(device),
                           backend)
    if why:
        raise SystemExit(f"train_cli: {why}")
    use_parallel = opt.batch_size > 1 and world >= opt.batch_size
    if world > 1:
        print(f"data parallel: rank {rank} of {world}")
    if opt.batch_size > 1 and not use_parallel:
        print(f"batch_size={opt.batch_size} needs >= that many devices "
              f"(have {world}); falling back to batch_size=1")
    # training snapshots are single-process only (train.py:476-477)
    snapshots = (model.render_process and not args.bench_iters
                 and not args.eval_only and world == 1)
    if snapshots and importlib.util.find_spec("PIL") is None:
        raise SystemExit("train_cli: the training snapshots (render_process) "
                         "need Pillow, which is not installed")

    random.seed(args.seed)
    np.random.seed(args.seed % (2 ** 31))
    dev = configure_device(device)

    if not model.model_path:
        model.model_path = os.path.join("./output", args.expname)
    os.makedirs(model.model_path, exist_ok=True)
    # cfg_args records the effective configuration, config file merged in
    dump = dict(vars(args))
    for grp in (model, opt, pipe, hyper, cfg, field):
        for fld in dataclasses.fields(grp):
            if not fld.name.startswith("_"):
                dump[fld.name] = getattr(grp, fld.name)
    if is_primary():
        with open(os.path.join(model.model_path, "cfg_args"), "w") as f:
            f.write(repr(dump))

    print(f"Loading scene from {model.source_path}")
    scene = load_scene(model, pool_capacity=model.pool_capacity or None,
                       device=dev)
    print(f"  {len(scene.info.points)} init points, "
          f"{len(scene.get_train_cameras())} train cams, "
          f"{len(scene.get_test_cameras())} test cams, "
          f"extent {scene.cameras_extent:.2f}")
    if is_primary():
        write_cameras_json(os.path.join(model.model_path, "cameras.json"),
                           scene.get_test_cameras(),
                           scene.get_train_cameras())

    # every rank starts from rank 0's state (a no-op for one process)
    state = replicate_state(init_state(
        scene.pool, make_deformation(hyper, field, args.seed, dev),
        scene.aabb))
    bg = torch.tensor([1.0, 1.0, 1.0] if model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    if cfg.max_visible == 0:
        cfg.max_visible = auto_max_visible(scene.info.points,
                                           scene.get_train_cameras(),
                                           scene.pool.capacity,
                                           group_by_frame=opt.multicam > 1)
        print(f"auto-sized max_visible = {cfg.max_visible}")
    print(spans.host_line())

    start_stage, start_iter = "coarse", 0
    if args.start_checkpoint:
        state, start_stage, start_iter = ckpt.load_checkpoint(
            args.start_checkpoint, state)
        state = replicate_state(state)
        print(f"resumed from {args.start_checkpoint} at "
              f"{start_stage}:{start_iter}")
    elif args.eval_only:
        # --eval_only without an explicit checkpoint evaluates the model
        # trained in model_path (the reference restores before its sweep,
        # train.py:630-641), never the fresh init
        state, path, start_stage, start_iter = ckpt.restore_latest(
            model.model_path, state, "--eval_only")
        print(f"--eval_only: restored {path} ({start_stage}:{start_iter})")

    # blocks, and on the card every step, replay the captured step
    # (the CPU and a gloo group on the card take eager steps outside
    # blocks)
    replay = dev.type == "cuda" and backend in (None, "nccl")

    def evaluate(stage, step, st):
        graphs.release()      # the captured step's memory goes first
        eval_dir = os.path.join(model.model_path, "eval")
        os.makedirs(eval_dir, exist_ok=True)
        return do_evaluation(
            scene.get_train_cameras(), scene.get_test_cameras(),
            scene.get_full_cameras(), st.pool, st.deform, pipe, bg, st.aabb,
            model.sh_degree, stage, cfg, eval_dir, step=step,
            write=is_primary())

    if args.eval_only:
        res = evaluate(start_stage if start_iter else "fine",
                       int(state.step), state)
        print(json.dumps(res, indent=2))
        return state
    logger_path = os.path.join(model.model_path, "logger.json")

    def log(entry):
        if is_primary():
            with open(logger_path, "a") as f:
                json.dump(entry, f)
                f.write("\n")

    def save(stage, iteration, st):
        # torch.save is not collective: rank 0 writes, the others wait
        if is_primary():
            ckpt.save_checkpoint(model.model_path, stage, iteration, st)
        sync_hosts("ckpt")

    def scene_reconstruction(state, stage, first_iter, final_iter):
        if first_iter <= 1:
            # a stage starts with fresh Adam moments and schedules; a
            # resume keeps the loaded ones
            state = reinit_optimizer(state)
        cams = scene.get_train_cameras()
        stack = []
        ema_loss = 0.0
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        active_sh = 0
        t_start = time.time()
        n_done = 0
        log_every = max(int(os.environ.get("S3G_LOG_EVERY", "100")), 1)
        if use_parallel:
            # every rank pops the same global batch (identical seeds) and
            # keeps its own row of it
            b_lo, b_hi = local_batch_slice(opt.batch_size)

        def pop_cam():
            nonlocal stack
            if not stack:
                stack = list(range(len(cams)))
                random.shuffle(stack)
            return cams[stack.pop()]

        # --multicam B: a rig of B same-time cameras per step, drawn from
        # the seeded `random` in train.py's order; with --batch_size each
        # rank takes one rig
        mc = max(int(opt.multicam), 0)
        groups = group_by_time(cams) if mc > 1 else []
        gstack = []

        def pop_group():
            nonlocal gstack
            if not gstack:
                gstack = list(range(len(groups)))
                random.shuffle(gstack)
            g = groups[gstack.pop()]
            idx = (random.sample(g, mc) if len(g) >= mc
                   else random.choices(g, k=mc))
            return [cams[i] for i in idx]

        def event_after(i):
            """Host work runs after step i (log, densify, reset,
            checkpoint, evaluation, snapshot, the end of --bench_iters):
            a block must end there (train.py's rule)."""
            if i % log_every == 0 or i == first_iter or i == MID_EVAL_ITER:
                return True
            if i in args.checkpoint_iterations:
                return True
            if i < opt.densify_until_iter and (
                    (i > opt.densify_from_iter
                     and i % opt.densification_interval == 0)
                    or i % opt.opacity_reset_interval == 0):
                return True
            if (opt.prune_after_densify and i >= opt.densify_until_iter
                    and i % opt.densification_interval == 0):
                return True
            if (model.render_process and not args.bench_iters
                    and snapshot_due(i)):
                return True
            return bool(args.bench_iters
                        and n_done + (i - iteration) >= args.bench_iters)

        if use_parallel:
            step, scan = ((parallel_train_step_multicam,
                           parallel_train_steps_scan_multicam) if mc > 1
                          else (parallel_train_step,
                                parallel_train_steps_scan))
        else:
            step, scan = ((train_step_multicam, train_steps_scan_multicam)
                          if mc > 1 else (train_step, train_steps_scan))
        pop = pop_group if mc > 1 else pop_cam
        spd = max(int(args.steps_per_dispatch), 1)
        iteration = first_iter
        while iteration <= final_iter:
            if iteration % 1000 == 0:
                active_sh = min(active_sh + 1, model.sh_degree)
            # a block of spd steps in one dispatch when no host event
            # and no SH bump falls inside it
            block_ok = (spd > 1 and iteration + spd - 1 <= final_iter
                        and not any(event_after(iteration + j)
                                    for j in range(spd - 1))
                        and not any((iteration + j) % 1000 == 0
                                    for j in range(1, spd)))
            n = spd if block_ok else 1
            if use_parallel:
                views = [[pop() for _ in range(opt.batch_size)][b_lo:b_hi][0]
                         for _ in range(n)]
            else:
                views = [pop() for _ in range(n)]
            common = (stage, active_sh, hyper, opt, pipe, cfg,
                      scene.cameras_extent, bg)
            if block_ok or replay:
                state, aux = (scan(state, views, mc, *common) if mc > 1
                              else scan(state, views, *common))
                aux = last_step(aux)
            else:
                state, aux = step(state, views[0], *common)
                aux = small_aux(aux)
            n_done += n
            iteration += n - 1

            if iteration % log_every == 0 or iteration == first_iter:
                m = {k: float(v) for k, v in aux["metrics"].items()}
                ema_loss = 0.4 * m["loss"] + 0.6 * ema_loss
                entry = {"step": iteration, "stage": stage,
                         "Loss": round(ema_loss, 7),
                         "psnr": round(m["psnr"], 2),
                         "point": int(state.pool.n_alive),
                         "n_pairs": int(aux["n_pairs"]),
                         "ovf_rect": int(aux["overflow_rect"]),
                         "ovf_vis": int(aux["overflow_visible"]),
                         "ovf_pairs": int(aux["overflow_pairs"]),
                         "nan_skips": int(state.nan_skips),
                         "it_per_s": round(n_done / (time.time() - t_start),
                                           3),
                         "radii_max": round(float(aux["radii_max"]), 1),
                         "n_r20": int(aux["n_r20"])}
                if os.environ.get("S3G_PROBE"):
                    pr = probe_pool(state, opt, scene.cameras_extent)
                    entry["probe"] = {k: round(float(v), 8)
                                      for k, v in pr.items()}
                print(entry)
                # beside the entry, not in logger.json (train.py's keys)
                if "span_ns" in aux:
                    print(spans.step_line(aux))
                log(entry)

            if snapshots and snapshot_due(iteration):
                from s3gaussian_tpu_torch.eval.snapshots import \
                    render_training_image
                for tag, split in (("train", cams),
                                   ("test", scene.get_test_cameras())):
                    if split:
                        render_training_image(
                            model.model_path, stage + tag, iteration,
                            split[iteration % len(split)], state.pool,
                            state.deform, pipe, bg, state.aabb, active_sh,
                            stage, cfg, elapsed=time.time() - t_start)

            # density control (reference train.py:489-516)
            if iteration < opt.densify_until_iter:
                gthr, othr = densify_schedule(iteration, stage, opt)
                size_thr = (20.0 if iteration > opt.opacity_reset_interval
                            else None)
                if (iteration > opt.densify_from_iter
                        and iteration % opt.densification_interval == 0):
                    state, info = densify_step(state, gen, gthr, othr,
                                               scene.cameras_extent, size_thr,
                                               opt)
                    log({"step": iteration, "stage": stage,
                         "densify": {k: int(v) for k, v in info.items()}})
                if iteration % opt.opacity_reset_interval == 0:
                    print("reset opacity")
                    state = opacity_reset_step(state)
                    log({"step": iteration, "stage": stage,
                         "opacity_reset": True})
            elif (opt.prune_after_densify
                  and iteration % opt.densification_interval == 0):
                # prune-only continuation past densify_until_iter: opacity
                # and world-size prunes, no clone/split and no screen prune
                _, othr = densify_schedule(iteration, stage, opt)
                state, info = densify_step(state, gen, 1e30, othr,
                                           scene.cameras_extent, None, opt,
                                           world_prune=True)
                log({"step": iteration, "stage": stage,
                     "prune_only": {k: int(v) for k, v in info.items()}})

            if iteration in args.checkpoint_iterations:
                print(f"[ITER {iteration}] saving checkpoint")
                save(stage, iteration, state)

            # mid-training evaluation (reference train.py:533-551)
            if iteration == MID_EVAL_ITER and not args.bench_iters:
                print(f"[ITER {iteration}] mid-training evaluation")
                print(json.dumps(evaluate(stage, iteration, state),
                                 indent=2))

            if args.bench_iters and n_done >= args.bench_iters:
                break
            iteration += 1
        return state

    if start_stage == "coarse":
        state = scene_reconstruction(state, "coarse", start_iter + 1,
                                     opt.coarse_iterations)
        save("coarse", opt.coarse_iterations, state)
        start_iter = 0

    if args.prior_checkpoint:
        print(f"transplanting deformation from {args.prior_checkpoint}")
        state = ckpt.transplant_deformation(args.prior_checkpoint, state)

    state = scene_reconstruction(state, "fine", start_iter + 1,
                                 opt.iterations)
    graphs.release()
    save("fine", opt.iterations, state)
    if is_primary():
        ckpt.save_ply_pool(os.path.join(
            model.model_path, "point_cloud", f"iteration_{opt.iterations}",
            "point_cloud.ply"), state.pool)
    sync_hosts("ckpt_fine")

    if not args.bench_iters and not args.skip_final_eval:
        print(json.dumps(evaluate("fine", int(state.step), state),
                         indent=2))
    return state


if __name__ == "__main__":
    main()
