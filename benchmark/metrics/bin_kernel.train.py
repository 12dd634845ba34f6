"""bin_kernel.train: the share of the step's own binnings whose pair keys
the key-emission kernel wrote (``csrc/bin_keys.cu``, one launch a
binning): the sum of the steps' ``bins_kernel`` over the sum of their
``raster_passes`` less ``bins_reused`` (the passes that took another
pass's binning bin nothing) over the traced window, in %.  None where the
program counts no ``bins_kernel`` (a program before the kernel) or bins
nothing."""

from benchmark.metrics._span_record import traced


def read(ctx):
    got = traced(ctx)
    if got is None:
        return None
    _, steps = got
    if not {"raster_passes", "bins_reused", "bins_kernel"} <= set(steps):
        return None
    binnings = int((steps["raster_passes"] - steps["bins_reused"]).sum())
    if binnings <= 0:
        return None
    return 100.0 * int(steps["bins_kernel"].sum()) / binnings
