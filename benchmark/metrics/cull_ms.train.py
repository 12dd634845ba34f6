"""cull_ms.train: milliseconds a step of the pre-deformation cull, the
``cull`` span (the undeformed pool projected for each camera of the rig,
the union ordered and gathered to the working set), summed over the
traced window's steps over their number; None where no step culls."""

from benchmark.metrics._span_record import step_ms


def read(ctx):
    return step_ms(ctx, ("cull",))
