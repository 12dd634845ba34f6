"""loss_ms.train: milliseconds a step of the loss, the ``loss.fwd`` and
``loss.bwd`` spans (L1, D-SSIM, depth, the feature term, dx and dshs,
the hexplane terms, and their backward to the render's maps), summed
over the traced window's steps over their number."""

from benchmark.metrics._span_record import step_ms


def read(ctx):
    return step_ms(ctx, ("loss.fwd", "loss.bwd"))
