"""The traced run: ``torch.profiler`` over the window, and what the
per-layer readers and the ``breakdown`` take from its trace.

The window is a ``record_function`` range named ``WINDOW``; its host
interval bounds every reading.  Device activity is every kernel, memcpy
and memset the trace records (CUPTI records the kernels of a replayed
CUDA graph one by one); ``busy_s`` is the length of their union inside
the window.  An idle gap, a stretch of the window with no device
activity, is labelled by the host operation that overlaps it most.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "benchmark_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# name parts whose device seconds a traced run logs
GROUPS = ("composite_fwd", "composite_bwd", "segment_sum", "RadixSort",
          "gather", "index", "reduce_kernel", "elementwise", "Memcpy",
          "bfloat16")


def start():
    """A started profiler of host and device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


@contextlib.contextmanager
def window(prof):
    """The window's range; stops ``prof`` (when given) at its end."""
    if prof is None:
        yield
        return
    try:
        with torch.profiler.record_function(WINDOW):
            yield
    finally:
        prof.__exit__(None, None, None)


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def parse(events: List[Dict]) -> Dict:
    """Window, device intervals by name and host intervals, in seconds
    of the trace's clock, from Chrome-trace events."""
    win: Optional[Tuple[float, float]] = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") == WINDOW:
            win = (a, b)
        elif cat in DEVICE_CATS:
            device.append((a, b, e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "")))
    if win is None:
        raise RuntimeError("the trace holds no window range")
    return {"window": win, "device": device, "host": host}


def reduce(parsed: Dict, top: int = 10) -> Dict:
    """busy_s, window_s, device seconds by name inside the window, and the
    breakdown's two lists."""
    lo, hi = parsed["window"]
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in parsed["device"]
              if b > lo and a < hi]
    by_name: Dict[str, float] = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ivs = [(a, b) for a, b, _ in inside]
    idle = gaps(ivs, lo, hi)
    labelled = []
    host = sorted(parsed["host"])
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        best, what = 0.0, "host: no operation recorded"
        for ha, hb, n in host:
            if ha >= b:
                break
            ov = min(b, hb) - max(a, ha)
            if ov > best:
                best, what = ov, n
        labelled.append([what[:200], b - a])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": hi - lo, "busy_s": union_length(ivs, lo, hi),
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[n[:200], s] for n, s in ops],
                          "idle_gaps": labelled}}


def summary(prof, ctx: Dict) -> Dict:
    """``reduce`` of the profiler's trace, written to and read back from
    a file under TMPDIR, which is then removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce(parse(events))
    groups = {g: sum(t for n, t in out["kernel_s"].items() if g in n)
              for g in GROUPS}
    ctx["log"](f"trace: window {out['window_s']:.6f} s, device busy "
               f"{out['busy_s']:.6f} s, {len(out['kernel_s'])} device "
               f"operations by name; device seconds by name part "
               f"{groups}")
    return out
