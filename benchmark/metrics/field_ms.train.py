"""field_ms.train: milliseconds a step of the deformation field, the
``field.fwd`` and ``field.bwd`` spans (the hexplane sample, the heads and
the activations; their backward with the segment sums), summed over the
traced window's steps over their number."""

from benchmark.metrics._span_record import step_ms


def read(ctx):
    return step_ms(ctx, ("field.fwd", "field.bwd"))
