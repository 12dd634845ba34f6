"""One run of one benchmark cell of the PyTorch/CUDA port, from the root
of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything the run needs is found by name from ``BENCHMARK.json``: the
cell's configuration (``benchmark/configs/<config>.json``), its traffic
mix (``benchmark/mixes/<traffic>.json``, whose ``kind`` names the runner
in ``benchmark/harness/<kind>.py``), the limits of the numbers that
decide ``correct`` (``benchmark/limits/<workload>.json``) and, in a
traced run, a reader per per-layer metric
(``benchmark/metrics/<metric>.py``, ``read(ctx)`` returning a number or
None; ``ctx["config"]`` is the cell's configuration).  The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Without a CUDA card (or with fewer than the cell asks for) the run exits
2 and prints no result; with JAX or the JAX package loaded by then, 3.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run lives in the checkout, at a
# fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "s3gaussian_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = _ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key: str, name: str) -> Dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        return self._named("workloads", name)

    def config(self, name: str) -> Dict:
        return load_json(os.path.join(self.root,
                                      self._named("configs", name)["file"]))

    def mix(self, name: str) -> Dict:
        return load_json(os.path.join(self.root, "benchmark", "mixes",
                                      f"{name}.json"))

    def limits(self, workload: str) -> Dict[str, float]:
        return load_json(os.path.join(self.root, "benchmark", "limits",
                                      f"{workload}.json"))

    def runner(self, kind: str):
        return importlib.import_module(f"benchmark.harness.{kind}")

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = os.path.join(self.root, "benchmark", "metrics",
                            f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def execute(bench: Bench, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda") -> Dict:
    """One run on ``device``; returns the result object (and the checks
    under ``checks``).  The caller checks the device."""
    import torch
    from s3gaussian_tpu_torch.device import configure_device

    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    limits = bench.limits(workload)
    dev = configure_device(device)
    ctx = {"config": config, "mix": mix, "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace), "dev": dev,
           "log": log, "process_age": process_age, "workload": workload}
    res = bench.runner(mix["kind"]).run(ctx)

    checks = {k: {"value": res["numbers"][k]["value"], "limit": v}
              for k, v in limits.items()}
    correct = (res["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    on_card = dev.type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(res["peak_bytes"])}
    values = {"setup_s": res["setup_s"],
              "peak_mem_gib": res["peak_bytes"] / 2 ** 30}
    values.update(res.get("rates", {}))
    metrics: Dict[str, Dict] = {}
    out: Dict = {"correct": bool(correct), "attempted": int(res["attempted"]),
                 "failed": int(res["failed"])}
    if trace:
        layer = dict(res["layer"], config=config)
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = layer["busy_s"]
        device_info["window_s"] = layer["window_s"]
        out.update(metrics=metrics, device=device_info,
                   breakdown=layer["breakdown"])
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        out.update(metrics=metrics, device=device_info)
    out["checks"] = checks
    shares = {k: v["value"] for k, v in metrics.items()} if trace else {}
    log(f"card {card_line() if on_card else 'cpu'}; per-layer {shares}; "
        f"run {workload} seed "
        f"{seed}: {res['steps']} steps, {res['views']} views in "
        f"{res['window_s']:.6f} s; losses program {res['losses'][0]} "
        f"reference {res['losses'][1]}; later steps' loss gaps (not "
        f"compared) {res['numbers']['later_loss_gaps']}; worst leaves "
        f"{ {k: res['numbers'][k]['leaf'] for k in limits} }; still "
        f"leaves {res['numbers']['still_leaves']}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
