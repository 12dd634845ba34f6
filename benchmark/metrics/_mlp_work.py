"""The deformation field's decoder: its work, counted from a
configuration's ``"model"`` widths, and its time, the program's inner
spans ``field.mlp.fwd`` and ``field.mlp.bwd``
(``s3gaussian_tpu_torch/utils/spans.py``), where the program has them.

The decoder is everything after the hexplane query, the Linears of
``benchmark/frozen/flops.py::decoder_linears`` (the one definition of
its layers that the step's count also takes), each head's output added
to its attribute.  Conventions of ``benchmark/frozen/flops.py``: an FMA is
two operations, compares and selects (the ReLUs) none; a Linear(i, o)
takes 2·i·o + o a row, a head's residual add o.  Bytes: each Linear's
input read and output written once a row in float32, and its weights
and biases once.  The backward is twice the forward, in operations and
in bytes (an input and a weight product for each matmul).  The spans
also hold the activations of scale, rotation and opacity, a few
operations a row, which are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.frozen.flops import (BACKWARD, HEADS, decoder_linears,
                                    least_s)


def row_ops(model: Dict) -> int:
    """Operations of one row through the decoder's forward."""
    adds = sum(out for flag, out in HEADS if not model[flag])
    return sum(2 * i * o + o for i, o in decoder_linears(model)) + adds


def row_bytes(model: Dict) -> int:
    """Bytes one row moves through the decoder's forward."""
    return sum(4 * (i + o) for i, o in decoder_linears(model))


def weight_bytes(model: Dict) -> int:
    """Bytes of the decoder's weights and biases."""
    return sum(4 * (i * o + o) for i, o in decoder_linears(model))


def step_least_s(model: Dict, rows: int) -> float:
    """The least time of the decoder's forward and backward over ``rows``
    rows on the card (the larger of operations at 67 TFLOP/s and bytes at
    3.35 TB/s)."""
    k = 1 + BACKWARD
    return least_s(k * rows * row_ops(model),
                   k * (rows * row_bytes(model) + weight_bytes(model)))


def traced(ctx) -> Optional[Tuple[List[int], List[int]]]:
    """(the decoder's inner-span ns, the field's rows) of every traced
    step, or None: without a run on the card, a span record, kept steps
    or an inner span in them."""
    from benchmark.metrics._span_record import traced as span_steps
    got = span_steps(ctx)
    if got is None:
        return None
    spans, steps = got
    names = getattr(spans, "INNER_NAMES", ())
    if "inner_ns" not in steps or not {"field.mlp.fwd",
                                       "field.mlp.bwd"} <= set(names):
        return None
    cols = [names.index("field.mlp.fwd"), names.index("field.mlp.bwd")]
    ns = steps["inner_ns"][:, cols].sum(1).tolist()
    if sum(ns) <= 0:
        return None
    return ns, steps["field_rows"].tolist()
