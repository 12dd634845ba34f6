"""mfu.train: the floating-point operations the traced window's steps
require (``benchmark/frozen/flops.py``: the field forward and backward,
projection and SH, every compositor pass, the loss and Adam) over the
window's seconds and the card's 67 TFLOP/s of float32, in %."""

from benchmark.frozen.flops import F32_FLOPS


def read(ctx):
    if not ctx.get("flops") or ctx.get("window_s", 0) <= 0:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * F32_FLOPS)
