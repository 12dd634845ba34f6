"""device_idle.train: the share of the traced window in which no
operation ran on the card (1 - the union of device activity over the
window), in %."""


def read(ctx):
    if ctx.get("window_s", 0) <= 0 or ctx.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
