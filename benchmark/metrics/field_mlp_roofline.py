"""field_mlp_roofline: the deformation field decoder's least time over
its span time (``field.mlp.fwd`` + ``field.mlp.bwd``) over the traced
window's steps, in %.  The least time of a step is the larger of its
operations at 67 TFLOP/s and its bytes at 3.35 TB/s (``_mlp_work.py``),
over the step's ``field_rows``, from the widths of the cell's
configuration (``ctx["config"]["model"]``).  It counts the hexplane
field's decoder: a configuration that names another ``"field"`` reads
nothing here."""

from benchmark.metrics._mlp_work import step_least_s, traced


def read(ctx):
    config = ctx.get("config")
    if config is None or "field" in config:
        return None
    got = traced(ctx)
    if got is None:
        return None
    ns, rows = got
    least = sum(step_least_s(config["model"], r) for r in rows)
    return 100.0 * least / (sum(ns) / 1e9)
