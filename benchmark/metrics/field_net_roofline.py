"""field_net_roofline: the deformation network's least time over its
span time (``field.mlp.fwd`` + ``field.mlp.bwd``) over the traced
window's steps, in %, for a configuration that names its ``"field"``.
The least time of a step is the larger of its operations at 67 TFLOP/s
and its bytes at 3.35 TB/s, forward and backward (twice the forward),
over the step's ``field_rows``: ``row_ops``, ``row_bytes`` and
``weight_bytes`` of the module that the field's ``"work"`` names, on the
configuration's ``"model"`` and the field's ``"params"``.  The counts are
the network's whole: its input encoding and its first Linear's weight
product, which the program runs outside the spans, are counted (about 3%
of the operations of Deformable 3D Gaussians' network), so the share
reads that much high.  Without a ``"field"`` (the hexplane field, which
``field_mlp_roofline`` reads), or with a work module that lacks the
three, it reads nothing."""

import importlib

from benchmark.frozen.flops import BACKWARD, least_s
from benchmark.metrics._mlp_work import traced

COUNTS = ("row_ops", "row_bytes", "weight_bytes")


def read(ctx):
    config = ctx.get("config")
    if config is None or "field" not in config:
        return None
    work = importlib.import_module(
        config["field"]["work"].partition(":")[0])
    if not all(hasattr(work, name) for name in COUNTS):
        return None
    got = traced(ctx)
    if got is None:
        return None
    ns, rows = got
    model, params = config["model"], config["field"]["params"]
    ops, row_bytes, weights = (getattr(work, name)(model, params)
                               for name in COUNTS)
    k = 1 + BACKWARD
    least = sum(least_s(k * r * ops, k * (r * row_bytes + weights))
                for r in rows)
    return 100.0 * least / (sum(ns) / 1e9)
