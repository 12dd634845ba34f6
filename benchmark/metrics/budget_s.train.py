"""budget_s.train: seconds of set-up in the ``budget`` host span, the
render budget auto-sized on the host (``train_cli.py::auto_max_visible``
over every training camera); None where the configuration sets it."""

from benchmark.metrics._span_record import host_s


def read(ctx):
    return host_s(ctx, ("budget",))
