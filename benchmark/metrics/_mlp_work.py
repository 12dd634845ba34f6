"""The deformation field's decoder: its work, counted from a
configuration's ``"model"`` widths, and its time, the program's inner
spans ``field.mlp.fwd`` and ``field.mlp.bwd``
(``s3gaussian_tpu_torch/utils/spans.py``), where the program has them.

The decoder is everything after the hexplane query: ``feature_out``
(Linear(C·S, W), then max(D − 1, 0) of ReLU, Linear(W, W)), each head
that is on (ReLU, Linear(W, W), ReLU, Linear(W, out), its output added
to its attribute) and the DINO head (Linear(W, 64), Linear(64, 64),
Linear(64, 3)).  Conventions of ``benchmark/frozen/flops.py``: an FMA is
two operations, compares and selects (the ReLUs) none; a Linear(i, o)
takes 2·i·o + o a row, a head's residual add o.  Bytes: each Linear's
input read and output written once a row in float32, and its weights
and biases once.  The backward is twice the forward, in operations and
in bytes (an input and a weight product for each matmul).  The spans
also hold the activations of scale, rotation and opacity, a few
operations a row, which are not counted.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from benchmark.frozen.flops import BACKWARD, least_s

HEADS = (("no_dx", 3), ("no_ds", 3), ("no_dr", 4), ("no_do", 1),
         ("no_dshs", 48))


def config_model(name: str) -> Dict:
    """The ``"model"`` of ``benchmark/configs/<name>.json``."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", f"{name}.json")
    with open(path) as f:
        return json.load(f)["model"]


def linears(model: Dict) -> List[Tuple[int, int]]:
    """(inputs, outputs) of every Linear of the decoder, in order."""
    c = (model["kplanes_config"]["output_coordinate_dim"]
         * len(model["multires"]))
    w = model["net_width"]
    layers = [(c, w)] + [(w, w)] * max(model["defor_depth"] - 1, 0)
    for flag, out in HEADS:
        if not model[flag]:
            layers += [(w, w), (w, out)]
    if model["feat_head"]:
        layers += [(w, 64), (64, 64), (64, 3)]
    return layers


def row_ops(model: Dict) -> int:
    """Operations of one row through the decoder's forward."""
    adds = sum(out for flag, out in HEADS if not model[flag])
    return sum(2 * i * o + o for i, o in linears(model)) + adds


def row_bytes(model: Dict) -> int:
    """Bytes one row moves through the decoder's forward."""
    return sum(4 * (i + o) for i, o in linears(model))


def weight_bytes(model: Dict) -> int:
    """Bytes of the decoder's weights and biases."""
    return sum(4 * (i * o + o) for i, o in linears(model))


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
