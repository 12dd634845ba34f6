"""update_ms.train: milliseconds a step of the update, the ``update``
span (dead-row masking, the NaN watchdog, the learning rates, Adam and
the densification statistics), summed over the traced window's steps
over their number."""

from benchmark.metrics._span_record import step_ms


def read(ctx):
    return step_ms(ctx, ("update",))
