"""composite_bwd_roofline: the least time the window's backward
compositor passes could take (the larger of their operations over 67
TFLOP/s and their bytes over 3.35 TB/s, from the frozen work counts)
over the device time of ``composite_bwd`` kernels in the trace, in %."""


def kernel_seconds(ctx, name):
    return sum(s for k, s in ctx.get("kernel_s", {}).items() if name in k)


def read(ctx):
    t = kernel_seconds(ctx, "composite_bwd")
    if t <= 0 or not ctx.get("composite_bwd_least_s"):
        return None
    return 100.0 * ctx["composite_bwd_least_s"] / t
