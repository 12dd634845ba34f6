"""field_mlp_roofline: the deformation field decoder's least time over
its span time (``field.mlp.fwd`` + ``field.mlp.bwd``) over the traced
window's steps, in %.  The least time of a step is the larger of its
operations at 67 TFLOP/s and its bytes at 3.35 TB/s (``_mlp_work.py``),
over the step's ``field_rows``, from the widths of
``benchmark/configs/waymo_4dgs.json``: the one cell that reports this
share is ``waymo_4dgs.train``, and a reader is handed no
configuration."""

from benchmark.metrics._mlp_work import config_model, step_least_s, traced

CONFIG = "waymo_4dgs"


def read(ctx):
    got = traced(ctx)
    if got is None:
        return None
    ns, rows = got
    model = config_model(CONFIG)
    least = sum(step_least_s(model, r) for r in rows)
    return 100.0 * least / (sum(ns) / 1e9)
