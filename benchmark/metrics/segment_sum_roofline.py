"""segment_sum_roofline: the least time of the window's ordered sums
under the field's grid gradients (each value and permutation entry read
once, each sum written once, at 3.35 TB/s) over the device time of
``segment_sum`` kernels in the trace, in %."""


def read(ctx):
    t = sum(s for k, s in ctx.get("kernel_s", {}).items()
            if "segment_sum" in k)
    if t <= 0 or not ctx.get("segment_sum_least_s"):
        return None
    return 100.0 * ctx["segment_sum_least_s"] / t
