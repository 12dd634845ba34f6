"""capture_s.train: seconds of set-up in the ``graph.warmup`` and
``graph.capture`` host spans (``train/graphs.py::capture``: the eager
warm-up step on a copy of the state, then the step captured as a CUDA
graph)."""

from benchmark.metrics._span_record import host_s


def read(ctx):
    return host_s(ctx, ("graph.warmup", "graph.capture"))
