"""field_mlp_ms.train: milliseconds a step of the deformation field's
decoder, the inner spans ``field.mlp.fwd`` (from the hexplane query's
return to the next top-level mark) and ``field.mlp.bwd`` (from the
field's outputs' gradients to the hexplane output's), summed over the
traced window's steps over their number.  Both lie inside
``field_ms.train``'s spans."""

from benchmark.metrics._mlp_work import traced


def read(ctx):
    got = traced(ctx)
    if got is None:
        return None
    ns, _ = got
    return sum(ns) / 1e6 / len(ns)
