"""Offline metrics over saved render directories (port of the
repository's ``metrics.py``): for each model path, every method under
``test/<method>/`` pairs ``renders/`` with ``gt/`` by file name, and
``results.json`` (mean PSNR, SSIM, VGG LPIPS) and ``per_view.json``
(PSNR and SSIM per file) are written beside ``test/``:

    python -m s3gaussian_tpu_torch.tools.metrics -m out1 [out2 ...]

The metrics are ``eval/metrics.py``'s, on the card.  LPIPS is null
unless ``S3G_LPIPS_WEIGHTS`` names an ``.npz`` of VGG weights.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.data.images import load_rgb
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.eval.metrics import lpips_or_none, psnr, ssim_skimage


def read_dir_pairs(renders_dir: str, gt_dir: str, device: torch.device
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                              List[str]]:
    """Each file of ``renders_dir`` and its namesake in ``gt_dir``, as
    float32 [H, W, 3] in [0, 1] on ``device``."""
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        for path, out in ((os.path.join(renders_dir, fname), renders),
                          (os.path.join(gt_dir, fname), gts)):
            out.append(torch.as_tensor(load_rgb(path), device=device))
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device: str = "cuda") -> Dict[str, Dict]:
    """Score every model path; returns {path: {method: results}}, the
    contents of each ``results.json``."""
    dev = configure_device(device)
    scores = {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict, per_view = {}, {}
        test_dir = os.path.join(scene_dir, "test")
        if not os.path.isdir(test_dir):
            print("  no test/ directory; skipping")
            continue
        for method in os.listdir(test_dir):
            mdir = os.path.join(test_dir, method)
            renders, gts, names = read_dir_pairs(
                os.path.join(mdir, "renders"), os.path.join(mdir, "gt"), dev)
            psnrs = [float(psnr(r, g)) for r, g in zip(renders, gts)]
            ssims = [float(ssim_skimage(r, g)) for r, g in zip(renders, gts)]
            lpipss = [lpips_or_none(r, g, net="vgg")
                      for r, g in zip(renders, gts)]
            lp = [x for x in lpipss if x is not None]
            full_dict[method] = {
                "PSNR": float(np.mean(psnrs)),
                "SSIM": float(np.mean(ssims)),
                "LPIPS": float(np.mean(lp)) if lp else None,
            }
            per_view[method] = {
                "PSNR": dict(zip(names, psnrs)),
                "SSIM": dict(zip(names, ssims)),
            }
            print(f"  {method}: PSNR {full_dict[method]['PSNR']:.4f} "
                  f"SSIM {full_dict[method]['SSIM']:.4f}")
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        scores[scene_dir] = full_dict
    return scores


def main(argv=None, device: str = "cuda") -> Dict[str, Dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, device)


if __name__ == "__main__":
    main()
