"""Multi-scene training driver of the port (counterpart of the repository's
``scripts/run_scenes.py``, with its flags and semantics): it trains each
scene of a split file or a list with the port's CLI and covers the
reference's scene matrix:

  * scene selection from a split file (``data/waymo_splits/*.txt``) or
    explicit directories, or every directory under ``--data_root``;
  * phase-1 reconstruction (no config), NVS (``arguments/nvs.py``,
    ``static_nvs.py``) and the phase-2 warm start
    (``arguments/stage2*.py``), ``--prior_checkpoint`` resolved per scene
    to the latest ``chkpnt_fine_*`` under ``<prior_root>/<scene>``; a
    scene without one is skipped as ``no_prior``;
  * ``--shard i/n``: the scenes whose index modulo n is i.

    python -m s3gaussian_tpu_torch.tools.run_scenes \\
        --data_root data/processed/dynamic32/training \\
        --split_file data/waymo_splits/dynamic32.txt --output work_dirs/recon
    python -m s3gaussian_tpu_torch.tools.run_scenes --data_root ... \\
        --scenes 016 021 --configs arguments/stage2_nvs.py \\
        --prior_root work_dirs/recon --output work_dirs/stage2 --shard 0/2

Each scene runs ``python -m s3gaussian_tpu_torch.train_cli`` in a process
of its own, on the card; with ``--batch_size B > 1`` among the forwarded
arguments (after ``--``) it runs ``torchrun --nproc_per_node B -m
s3gaussian_tpu_torch.train_cli``, one process per card.  With
``device="cpu"`` (the tests) a scene trains in this process, on the CPU.
``run_summary.json`` under ``--output`` is rewritten after every scene
trained; the exit code is 1 unless every scene is ``ok`` or ``dry_run``.
A chain runs the port's checkpoints: a stage-1 run that the JAX package
trained joins one once ``tools/exchange.py`` has imported it under
``<prior_root>/<scene>``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENTRY = "s3gaussian_tpu_torch.train_cli"


def scene_ids_from_split(split_file: str) -> List[str]:
    """The scene ids of a split file (first column, zero-padded to 3),
    blank and ``#`` lines skipped."""
    ids = []
    with open(split_file) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                ids.append(int(line.split(",")[0]))
    return [f"{i:03d}" for i in ids]


def find_prior_checkpoint(prior_root: str, scene: str) -> Optional[str]:
    """The ``chkpnt_fine_*`` of the highest iteration under
    ``<prior_root>/<scene>``, or None."""
    d = os.path.join(prior_root, scene)
    if not os.path.isdir(d):
        return None
    cands = [c for c in os.listdir(d) if c.startswith("chkpnt_fine_")]
    if not cands:
        return None
    latest = max(cands, key=lambda c: int(c.split("_")[-1]))
    return os.path.join(d, latest)


def batch_size(train_args: List[str]) -> int:
    """``--batch_size`` among the forwarded arguments, 1 without it."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--batch_size", type=int, default=1)
    return p.parse_known_args(train_args)[0].batch_size


def entry_command(train_args: List[str]) -> List[str]:
    """The launcher of one scene's training: the CLI in one process, or
    torchrun with one process per camera of a data-parallel batch."""
    b = batch_size(train_args)
    if b > 1:
        return ["torchrun", "--nproc_per_node", str(b), "-m", ENTRY]
    return [sys.executable, "-m", ENTRY]


def launch(cmd: List[str], device: str) -> int:
    """Run one scene's command; its exit code.  On the card, a process of
    its own (the repository on its import path); on the CPU,
    ``train_cli.main`` in this process."""
    if torch.device(device).type == "cpu":
        from s3gaussian_tpu_torch import train_cli
        train_cli.main(cmd[cmd.index(ENTRY) + 1:], device="cpu")
        return 0
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path
                                               else ""))
    return subprocess.call(cmd, env=env)


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description="Train a list of scenes with "
                                "the port's CLI")
    p.add_argument("--data_root", required=True,
                   help="directory containing per-scene clip folders")
    p.add_argument("--scenes", nargs="*", default=None,
                   help="explicit scene folder names (e.g. 016 021)")
    p.add_argument("--split_file", default=None,
                   help="split list in data/waymo_splits/ to select scenes")
    p.add_argument("--output", required=True)
    p.add_argument("--configs", default="",
                   help="arguments/*.py preset passed to the CLI")
    p.add_argument("--prior_root", default="",
                   help="phase-1 output root; enables --prior_checkpoint "
                        "chaining per scene (stage-2 warm start)")
    p.add_argument("--shard", default="0/1",
                   help="i/n: run scenes where index %% n == i")
    p.add_argument("--expname", default="waymo")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("train_args", nargs="*",
                   help="extra args forwarded to the CLI verbatim")
    args = p.parse_args(argv)

    if args.split_file:
        scenes = scene_ids_from_split(args.split_file)
    elif args.scenes:
        scenes = args.scenes
    else:
        scenes = sorted(d for d in os.listdir(args.data_root)
                        if os.path.isdir(os.path.join(args.data_root, d)))
    i, n = (int(x) for x in args.shard.split("/"))
    scenes = [s for k, s in enumerate(scenes) if k % n == i]

    os.makedirs(args.output, exist_ok=True)
    summary = []
    for scene in scenes:
        src = os.path.join(args.data_root, scene)
        model_path = os.path.join(args.output, scene)
        cmd = entry_command(args.train_args) + [
            "-s", src, "--model_path", model_path, "--expname", args.expname]
        if args.configs:
            cmd += ["--configs", args.configs]
        if args.prior_root:
            prior = find_prior_checkpoint(args.prior_root, scene)
            if prior is None:
                print(f"[{scene}] no prior checkpoint under "
                      f"{args.prior_root} — skipping")
                summary.append({"scene": scene, "status": "no_prior"})
                continue
            cmd += ["--prior_checkpoint", prior]
        cmd += list(args.train_args)
        print(f"[{scene}] {' '.join(cmd)}", flush=True)
        if args.dry_run:
            summary.append({"scene": scene, "status": "dry_run"})
            continue
        t0 = time.time()
        rc = launch(cmd, device)
        summary.append({"scene": scene, "status": "ok" if rc == 0 else
                        f"rc={rc}", "minutes": round((time.time() - t0) / 60,
                                                     1)})
        with open(os.path.join(args.output, "run_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0 if all(s["status"] in ("ok", "dry_run") for s in summary) else 1


if __name__ == "__main__":
    sys.exit(main())
