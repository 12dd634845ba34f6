"""bin_reuse.train: the share of the rasterizer's passes that took another
pass's binning instead of binning their own (a feature pass takes its
camera's RGB-pass pair keys, sort and tile ranges): the sum of the steps'
``bins_reused`` over the sum of their ``raster_passes`` over the traced
window, in %.  None where the program counts neither."""

from benchmark.metrics._span_record import traced


def read(ctx):
    got = traced(ctx)
    if got is None:
        return None
    _, steps = got
    if "raster_passes" not in steps or "bins_reused" not in steps:
        return None
    passes = int(steps["raster_passes"].sum())
    if passes <= 0:
        return None
    return 100.0 * int(steps["bins_reused"].sum()) / passes
