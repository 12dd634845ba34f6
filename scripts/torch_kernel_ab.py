#!/usr/bin/env python3
"""A/B of the PyTorch port's two CUDA tile compositors on one GPU.

Each TREE is a directory that holds an ``s3gaussian_tpu_torch`` package
(the repository root, or an unpacked ``git archive`` of another commit).
The trees run in the order given, each in its own process, which builds
that tree's kernels.  The inputs are those of ``chip_smoke.py`` phase 3,
made by this repository's ``chip_smoke.py`` helpers through the tree's
package: bench.py's headline scene (200,000 Gaussians, 640x960, seed 0),
the sorted pair streams of the front camera at t = 0.4 ("view") and of its
high-opacity variant, and the train loss's cotangent of each.  On each,
``composite_fwd`` is timed over 20 launches and ``composite_bwd`` over 10,
after 2 warm-up launches, with CUDA events: once launched from Python as a
caller launches them (``*_ms``; a kernel shorter than the wrapper's host
time reads as the host time), once replayed from a CUDA graph of the same
launches (``*_graph_ms``, device time).  Both include the wrapper's
allocations, for the backward the zeroed [16, M] gradient.  One JSON line
per tree and view; give each tree twice, in turns (A B B A), to see the
noise:

    python3 scripts/torch_kernel_ab.py PARENT . . PARENT
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FWD_REPS, BWD_REPS = 20, 10


def graph_ms(torch, fn, reps):
    """ms per call of ``fn`` replayed from a CUDA graph of ``reps`` calls
    (CUDA events around one replay, after a warm-up replay)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(tree: str) -> None:
    import torch

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from s3gaussian_tpu_torch.device import configure_device
    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    dev = configure_device("cuda")
    tk.build()
    card = smoke.card_line()
    su = smoke.headline(torch, dev)
    cfg = su.cfg
    tx, ty = cfg.tile_x, cfg.tile_y
    gx, gy = -(-smoke.W // tx), -(-smoke.H // ty)
    gt = torch.tensor(su.gt, device=dev)
    gt_depth = torch.tensor(su.gt_depth, device=dev)
    for view, (s, ts) in smoke.kernel_streams(torch, su).items():
        out = tk.composite_fwd(s, ts, gx, gy, tx, ty)
        dout = smoke.step_loss_cotangent(torch, out, gt, gt_depth, su.opt,
                                         gx, gy, cfg)

        def fwd():
            return tk.composite_fwd(s, ts, gx, gy, tx, ty)

        def bwd():
            return tk.composite_bwd(s, ts, out, dout, gx, gy, tx, ty)

        print(json.dumps({
            "tree": tree, "view": view,
            "composite_fwd_ms": smoke.cuda_ms(torch, fwd, FWD_REPS),
            "composite_bwd_ms": smoke.cuda_ms(torch, bwd, BWD_REPS),
            "composite_fwd_graph_ms": graph_ms(torch, fwd, FWD_REPS),
            "composite_bwd_graph_ms": graph_ms(torch, bwd, BWD_REPS),
            "card": card}), flush=True)


def main(trees) -> int:
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               os.path.abspath(tree)]
        proc = subprocess.run(cmd, env=env, timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
