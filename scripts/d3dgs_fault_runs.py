"""The planted fault of ``waymo_d3dgs.train``'s limits, on the card: the
program adds Deformable 3D Gaussians' scaling delta to the raw scale
before exp (where the renderer adds it after), and each seed's run is
compared with the plain reference as ``benchmark.control`` compares the
program's.  One JSON line a seed:

    python3 scripts/d3dgs_fault_runs.py 3220000013,3220000014
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run as bench_run  # noqa: E402
from s3gaussian_tpu_torch.device import configure_device  # noqa: E402
from s3gaussian_tpu_torch.models import deform_mlp  # noqa: E402

WORKLOAD = "waymo_d3dgs.train"
real = deform_mlp.DeformMLP.forward


def delta_before_exp(self, *args):
    out = real(self, *args)
    return out._replace(scales=out.scales + out.d_scales, d_scales=None)


def main(seeds):
    deform_mlp.DeformMLP.forward = delta_before_exp
    bench = bench_run.Bench()
    config = bench.config(bench.cell(WORKLOAD)["config"])
    mix = bench.mix(bench.cell(WORKLOAD)["traffic"])
    dev = configure_device("cuda")
    for seed in seeds:
        ctx = {"config": config, "mix": mix, "seed": seed, "seconds": 0.0,
               "trace": False, "dev": dev, "log": bench_run.log,
               "process_age": bench_run.process_age, "workload": WORKLOAD}
        res = bench.runner(mix["kind"]).run(ctx)
        nums = res["numbers"]
        print(json.dumps({
            "seed": seed, "side": "fault_ds_before_exp",
            "failed": res["failed"],
            **{k: nums[k]["value"]
               for k in ("loss_gap", "grad_gap", "delta_gap")},
            "later_loss_gaps": nums["later_loss_gaps"]}), flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1].split(",")])
