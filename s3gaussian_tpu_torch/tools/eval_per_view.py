"""Per-view PSNR of a trained checkpoint (port of the repository's
``scripts/eval_per_view.py``): every train view rendered on the card,
its PSNR, and the distribution (mean, median, p10, p90) with the worst
views first and the three best, so a noisy training probe can be traced
to a few broken (frame, camera) views or to the whole split:

    python -m s3gaussian_tpu_torch.tools.eval_per_view --model_path out/

It rebuilds the run from ``cfg_args`` and restores the latest checkpoint
(``--checkpoint`` names another), as ``tools/trained.py`` does for every
offline tool.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import numpy as np
import torch

from s3gaussian_tpu_torch.eval.video import render_pixels
from s3gaussian_tpu_torch.tools.trained import load_trained, read_cfg_args


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """Print the per-view JSON (values at 2 decimals, as the JAX script
    prints them); return it unrounded."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--source", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--worst", type=int, default=12)
    args = p.parse_args(argv)

    run = read_cfg_args(args.model_path, args.source)
    tr = load_trained(run, args.model_path, args.checkpoint, device,
                      "eval_per_view")
    # an explicit checkpoint is scored as the fine stage, as the JAX
    # script does
    stage = "fine" if args.checkpoint else tr.stage
    cams = tr.scene.get_train_cameras()
    st = tr.state
    frames = render_pixels(cams, st.pool, st.deform, run.pipe,
                           torch.zeros(3, device=st.pool.xyz.device),
                           st.aabb, 3, stage, run.cfg,
                           return_decomposition=False)
    per_view = frames["metrics_per_view"]["psnr"]
    pairs = [(i, v) for i, v in enumerate(per_view) if v is not None]
    if not pairs:
        raise SystemExit("no views with GT images to score")
    psnrs = np.asarray([v for _, v in pairs], dtype=np.float64)
    rows = sorted(({"view": i, "frame": i // 3, "cam": i % 3,
                    "time": float(cams[i].time), "psnr": float(v)}
                   for i, v in pairs), key=lambda r: r["psnr"])
    res = {
        "n_views": len(psnrs),
        "mean": float(psnrs.mean()),
        "median": float(np.median(psnrs)),
        "p10": float(np.percentile(psnrs, 10)),
        "p90": float(np.percentile(psnrs, 90)),
        "worst": rows[:args.worst],
        "best": rows[-3:],
    }

    def shown(r):
        return {k: (v if k in ("view", "frame", "cam")
                    else round(v, 4 if k == "time" else 2))
                for k, v in r.items()}

    printed = {k: (round(v, 2) if isinstance(v, float) else v)
               for k, v in res.items()}
    printed["worst"] = [shown(r) for r in res["worst"]]
    printed["best"] = [shown(r) for r in res["best"]]
    print(json.dumps(printed, indent=2))
    return res


if __name__ == "__main__":
    main()
