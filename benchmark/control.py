"""The readings that the limits of a training cell's ``correct`` are set
from, at the cell's own size, in one process on the card:

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \
        [--control 3]

For every seed, the program's numbers: the cell's own runner with a
window of one block, compared with the plain reference as every run
compares them.  For the first ``--control`` seeds, the control's: the
reference computed with TF32 on for matmuls and convolutions (the
nearest precision below the float32 the configuration states, and the
step that would tempt a later change) put in the program's place; and,
in a rig cell, the fault of half the rig left out with the mean over
the rest, planted in the reference put in the program's place.  A state
left unchanged reads 1 on ``delta_gap`` by the measure and needs no run.
Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    from s3gaussian_tpu_torch.device import configure_device

    from benchmark.frozen import compare, reference
    from benchmark.harness import clip as clipgen
    bench = bench_run.Bench()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    dev = configure_device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        ctx = {"config": config, "mix": mix, "seed": seed, "seconds": 0.0,
               "trace": False, "dev": dev, "log": bench_run.log,
               "process_age": bench_run.process_age,
               "workload": args.workload}
        res = bench.runner(mix["kind"]).run(ctx)
        line = {"seed": seed, "side": "program", "failed": res["failed"],
                **{k: res["numbers"][k]["value"]
                   for k in ("loss_gap", "grad_gap", "delta_gap")},
                "later_loss_gaps": res["numbers"]["later_loss_gaps"]}
        print(json.dumps(line), flush=True)
        if i >= args.control:
            continue
        clip = clipgen.make_clip(config, seed, dev)
        units, ref = res["check_units"], res["reference"]
        kinds = [("control_tf32", dict(tf32=True))]
        if config["multicam"] > 1:
            kinds.append(("fault_half_batch", dict(fault="half_batch")))
        for name, kw in kinds:
            other = reference.run_steps(clip, config, seed, units, dev, **kw)
            nums = compare.train_numbers(other, ref)
            print(json.dumps({"seed": seed, "side": name, **{
                k: nums[k]["value"] for k in
                ("loss_gap", "grad_gap", "delta_gap")},
                "later_loss_gaps": nums["later_loss_gaps"]}), flush=True)
        del clip
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
