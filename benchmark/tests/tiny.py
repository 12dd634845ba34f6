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


# a gridless toy field (``toy_program.py``, ``toy_reference.py``) as a
# configuration names it
TOY_FIELD = {"program": "benchmark.tests.toy_program:build",
             "reference": "benchmark.tests.toy_reference:build",
             "work": "benchmark.tests.toy_reference:row_ops",
             "params": {"width": 16, "xyz_freqs": 2, "t_freqs": 2}}


def toy_tree(root: str) -> bench_run.Bench:
    """The tiny tree with one more configuration and cell, added as new
    files and entries only: ``toy``, the tiny ``waymo_default`` under
    the toy field (no grid, so no hexplane terms in the loss; no DINO or
    SH head), and ``toy.train``, which reports ``train_views_per_s`` and
    ``mfu.train``.  5,000 points: above 4,096 the program's KNN is the
    native search that the reference follows."""
    tiny_tree(root)
    bdir = os.path.join(root, "benchmark")
    cfg = bench_run.load_json(os.path.join(bdir, "configs",
                                           "waymo_default.json"))
    cfg.update(name="toy", num_pts=5000, capacity=8192, field=TOY_FIELD)
    cfg["raster"]["max_visible"] = 8192
    cfg["model"].update(no_dshs=True, feat_head=False,
                        time_smoothness_weight=0.0, plane_tv_weight=0.0,
                        l1_time_planes=0.0)
    with open(os.path.join(bdir, "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bdir, "limits", "waymo_default.train.json"),
                os.path.join(bdir, "limits", "toy.train.json"))
    path = os.path.join(root, "BENCHMARK.json")
    spec = bench_run.load_json(path)
    spec["configs"].append({"name": "toy", "source": "a test",
                            "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy.train", "config": "toy",
                              "traffic": "train", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_views_per_s", "mfu.train"):
            m["workloads"].append("toy.train")
    with open(path, "w") as f:
        json.dump(spec, f)
    return bench_run.Bench(root)
