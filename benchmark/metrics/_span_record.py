"""What the program-span readers share: the port's span record
(``s3gaussian_tpu_torch/utils/spans.py``), where the program has one.

A reader reads it only from a run on the card, a trace with device
activity: the harness's tests on the CPU run the cells at a tiny size,
whose spans are not the cell's.  Without a record (a program that has
none), or without a span of the names asked for, a reader returns None.
"""


def record(ctx):
    """The span record module, or None."""
    if ctx.get("busy_s", 0) <= 0:
        return None
    try:
        from s3gaussian_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def traced(ctx):
    """(the span record, the traced window's steps on the host), or
    None."""
    spans = record(ctx)
    steps = spans.traced_steps() if spans is not None else None
    return None if steps is None else (spans, steps)


def step_ms(ctx, names):
    """Milliseconds a step of the device spans ``names``: their sum over
    the traced window's steps over the number of steps."""
    got = traced(ctx)
    if got is None:
        return None
    spans, steps = got
    ns = steps["span_ns"][:, [spans.NAMES.index(n) for n in names]]
    if int(ns.sum()) <= 0:
        return None
    return float(ns.sum()) / 1e6 / ns.shape[0]


def host_s(ctx, names):
    """Seconds of the host spans ``names``, summed over the run."""
    spans = record(ctx)
    if spans is None:
        return None
    got = [s for n in names for s in spans.host_spans(n)]
    if not got:
        return None
    return sum(s.ms for s in got) / 1e3
