"""raster_ms.train: milliseconds a step of the rasterizer, the
``project.*``, ``bin.*`` and ``composite.*`` spans of every camera and pass
(projection, covariance and SH; pair keys, the sort and the stream's
gather; the compositors), forward and backward, summed over the traced
window's steps over their number."""

from benchmark.metrics._span_record import step_ms


def read(ctx):
    return step_ms(ctx, ("project.fwd", "bin.fwd", "composite.fwd",
                         "project.bwd", "bin.bwd", "composite.bwd"))
