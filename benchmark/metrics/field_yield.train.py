"""field_yield.train: the share of the deformation field's rows that
reach a view, the sum of the steps' ``visible_rows`` (rows of the field's
input visible in at least one camera of the step) over the sum of their
``field_rows`` (the rows entering the field) over the traced window, in
%."""

from benchmark.metrics._span_record import traced


def read(ctx):
    got = traced(ctx)
    if got is None:
        return None
    _, steps = got
    rows = int(steps["field_rows"].sum())
    if rows <= 0:
        return None
    return 100.0 * int(steps["visible_rows"].sum()) / rows
