"""Score a trained checkpoint's deformation field against ground-truth
scene flow, as end-point error (port of the repository's
``scripts/eval_flow_epe.py``):

    python -m s3gaussian_tpu_torch.tools.eval_flow_epe --model_path out/ \\
        [--offsets 1 3] [--out epe.json]

It works on clips whose generator wrote ``gt_motion.json``
(``tools/mini_clip.py``).  The learned flow is the field's dx difference
across timesteps (``eval/flow.py::deformation_flow_epe``), evaluated on
the card at the probe frames 0, n/3 and 2n/3 for each offset.  The run
is rebuilt from ``cfg_args`` and its latest checkpoint restored
(``tools/trained.py``); it prints one JSON dict of EPE metrics per
(probe frame, offset).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from s3gaussian_tpu_torch.eval.flow import deformation_flow_epe, load_gt_motion
from s3gaussian_tpu_torch.tools.trained import load_trained, read_cfg_args


def main(argv=None, device: str = "cuda") -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--source", default="",
                   help="clip dir (default: source_path from cfg_args)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint dir (default: latest in model_path)")
    p.add_argument("--offsets", nargs="+", type=int, default=[1, 3])
    p.add_argument("--out", default="",
                   help="write the metrics JSON here as well")
    args = p.parse_args(argv)

    run = read_cfg_args(args.model_path, args.source)
    src = run.model.source_path
    gt_motion = load_gt_motion(src)
    if gt_motion is None:
        raise SystemExit(f"no gt_motion.json in {src} — flow EPE needs "
                         "ground-truth trajectories")
    tr = load_trained(run, args.model_path, args.checkpoint, device,
                      "eval_flow_epe")

    n_frames = gt_motion.get("n_frames") or len(
        [f for f in os.listdir(os.path.join(src, "ego_pose"))
         if f.endswith(".txt")])
    probe = [0, n_frames // 3, 2 * n_frames // 3]
    st = tr.state
    results = deformation_flow_epe(st.pool, st.deform, st.aabb, gt_motion,
                                   n_frames, offsets=tuple(args.offsets),
                                   probe_frames=probe)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
