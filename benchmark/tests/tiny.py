"""A tiny copy of the benchmark's tree for CPU tests: the real
``BENCHMARK.json``, mixes, limits and metric readers, and the real
configurations cut to a few thousand points, 64x96 views and a small
hexplane."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import run as bench_run

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_tree(root: str) -> bench_run.Bench:
    """Write the tiny tree under ``root``; its ``Bench``."""
    bdir = os.path.join(root, "benchmark")
    for sub in ("mixes", "limits", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub),
                        os.path.join(bdir, sub))
    os.makedirs(os.path.join(bdir, "configs"))
    spec = bench_run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    for c in spec["configs"]:
        cfg = bench_run.load_json(os.path.join(REPO, c["file"]))
        cfg.update(num_pts=3000, capacity=4096)
        cfg["clip"].update(frames=12, height=64, width=96)
        cfg["model"]["kplanes_config"]["resolution"] = [8, 8, 8, 5]
        cfg["model"]["multires"] = [1, 2]
        cfg["raster"]["pair_budget"] = 1 << 16
        if cfg["raster"]["max_visible"]:
            cfg["raster"]["max_visible"] = 4096
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    mix = os.path.join(bdir, "mixes", "train.json")
    m = bench_run.load_json(mix)
    m["trace_max_blocks"] = 1
    with open(mix, "w") as f:
        json.dump(m, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return bench_run.Bench(root)
