"""The harness's arithmetic on hand-made cases: the busy union, the idle
gaps and their labels, the rate and peak of a result, the metric
readers, and the frozen counters of operations and bytes."""

from __future__ import annotations

import math

import pytest

from benchmark.frozen import compare, flops
from benchmark.frozen import work_counts as wc
from benchmark.harness import trace
from benchmark.run import Bench
from benchmark.tests.tiny import REPO


def test_union_and_gaps():
    ivs = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    assert trace.union_length(ivs, 0.0, 10.0) == pytest.approx(5.0)
    assert trace.gaps(ivs, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                          (7.0, 9.0)]
    assert trace.union_length([], 0.0, 1.0) == 0.0
    assert trace.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def _event(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_reduce_labels_gaps_by_host_work():
    events = [
        _event("user_annotation", trace.WINDOW, 0, 1000),
        _event("kernel", "k_a", 0, 300),
        _event("kernel", "k_b", 250, 150),      # overlaps k_a
        _event("gpu_memcpy", "copy", 600, 120),
        _event("kernel", "k_a", 900, 200),      # runs past the window
        _event("cuda_runtime", "cudaGraphLaunch", 390, 220),
        _event("cpu_op", "aten::copy_", 700, 150),
    ]
    r = trace.reduce(trace.parse(events))
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((400 + 120 + 100) * 1e-6)
    assert r["kernel_s"]["k_a"] == pytest.approx(400e-6)
    gaps = r["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["cudaGraphLaunch", "aten::copy_"]
    assert gaps[0][1] == pytest.approx(200e-6)
    assert r["breakdown"]["device_ops"][0] == ["k_a", pytest.approx(400e-6)]


def test_trace_without_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.parse([_event("kernel", "k", 0, 1)])


def test_readers():
    b = Bench(REPO)
    ctx = {"window_s": 2.0, "busy_s": 1.5, "flops": 67e12,
           "kernel_s": {"composite_bwd_kernel(x)": 0.2,
                        "segment_sum_kernel<1>": 0.1, "other": 1.0},
           "composite_bwd_least_s": 0.05, "segment_sum_least_s": 0.06,
           "pairs_per_view": 12.5}
    assert b.reader("device_idle.train")(ctx) == pytest.approx(25.0)
    assert b.reader("mfu.train")(ctx) == pytest.approx(50.0)
    assert b.reader("composite_bwd_roofline")(ctx) == pytest.approx(25.0)
    assert b.reader("segment_sum_roofline")(ctx) == pytest.approx(60.0)
    assert b.reader("pairs_per_view.train")(ctx) == 12.5
    # a reader with nothing to read returns nothing, never 0
    for name in ("device_idle.train", "mfu.train", "composite_bwd_roofline",
                 "segment_sum_roofline"):
        assert b.reader(name)({"window_s": 1.0, "busy_s": 0.0}) is None


def test_linear_and_field_counts():
    assert flops.linear(3, 2) == 2 * 3 * 2 + 2
    model = {"kplanes_config": {"output_coordinate_dim": 2},
             "multires": [1], "net_width": 4, "defor_depth": 1,
             "no_dx": False, "no_ds": True, "no_dr": True, "no_do": True,
             "no_dshs": True, "feat_head": False}
    # grid: 6 + (3 (8 + 14) + 3 (2 + 6) + 10) = 106; feature_out
    # linear(2, 4) = 20; the pos head linear(4, 4) + linear(4, 3) + 3 =
    # 36 + 27 + 3 = 66; the sums of dx and dshs 3 + 48
    assert flops.field_forward(model) == 106 + 20 + 66 + 51


@pytest.mark.parametrize("depth,hidden", [(0, 0), (1, 0), (2, 1)])
def test_field_forward_counts_the_decoders_layers(depth, hidden):
    """``waymo_4dgs``'s field at ``defor_depth`` 0, 1 and 2: the step's
    count takes the decoder's Linears that ``_mlp_work`` counts,
    max(D - 1, 0) Linear(128, 128) of them in ``feature_out``, and
    beside them only the grid (1,186), 3 a head and the sums of dx and
    dshs, less the heads' residual adds the decoder counts (59)."""
    from benchmark.metrics import _mlp_work as mw
    m = dict(Bench(REPO).config("waymo_4dgs")["model"], defor_depth=depth)
    layers = flops.decoder_linears(m)
    assert layers[1:1 + hidden] == [(128, 128)] * hidden
    assert len(layers) == 1 + hidden + 2 * 5
    assert flops.field_forward(m) == 189_215 + hidden * 32_896
    assert flops.field_forward(m) - mw.row_ops(m) == 1_186 + 15 + 51 - 59


def test_named_work_reaches_the_step():
    """A configuration's ``"field"`` brings its own count of a row into
    the step's; without one, ``field_forward``."""
    from benchmark.tests import toy_reference
    from benchmark.tests.tiny import TOY_FIELD
    model = Bench(REPO).config("waymo_default")["model"]
    toy = {"model": model, "field": TOY_FIELD}
    ops = toy_reference.row_ops(model, TOY_FIELD["params"])
    assert ops != flops.field_forward(model)
    assert flops.train_step(toy, 10, 0, 0, 0, [], 0) == 3 * 10 * ops
    assert flops.train_step({"model": model}, 10, 0, 0, 0, [], 0) == (
        3 * 10 * flops.field_forward(model))


def test_compositor_counts():
    c = {"evaluated": 10, "contributing": 4, "column_evaluating": 3,
         "column_contributing": 2, "needed": 5}
    assert flops.compositor(c, False) == 3 * 4 + 10 * 10 + 4 * (9 + 4)
    assert flops.compositor(c, True) == (3 * 4 + 10 * 10 + 4 * (22 + 12)
                                         + 2 * 3)
    # 2 tiles of 4 pixels, 6 pair slots
    assert flops.compositor_bytes(c, 2, 4, 6, False) == (
        5 * 40 + 3 * 4 + 2 * 8 * 4 * 4)
    assert flops.compositor_bytes(c, 2, 4, 6, True) == (
        5 * 40 + 3 * 4 + 2 * 2 * 5 * 4 * 4 + 16 * 6 * 4)


def test_segment_sum_bytes_and_least_time():
    assert flops.segment_sum_bytes([(10, 2, 3)]) == (
        10 * 2 * 4 + 10 * 8 + 4 * 8 + 3 * 2 * 4)
    assert flops.least_s(67e12, 0) == pytest.approx(1.0)
    assert flops.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.least_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_work_counts_by_hand():
    """One tile of 2x1 pixels (centres at x = 0 and 1) and five pairs
    centred on pixel 0 at alpha 0.95: pixel 0 evaluates four (the fourth
    sees T = 0.05^3 >= 1e-4 before it) and takes three (T after the
    fourth is under 1e-4); pixel 1, 1 px off at alpha 0.95 exp(-0.5),
    evaluates and takes all five."""
    import torch
    from benchmark.frozen.ref.ops import composite as comp
    stream = torch.zeros(comp.PAIR_FEAT_DIM, 5)
    stream[comp.FCA] = stream[comp.FCC] = 1.0
    stream[comp.FOP] = 0.95
    starts = torch.tensor([0, 5], dtype=torch.int32)
    evaluated, needed, groups = wc.work_counts(
        stream, starts, 1, 1, 2, 1, wc.column_groups(2, 1, "cpu"))
    assert (evaluated, needed) == (9, 5)
    assert groups["column"] == {"evaluating": 9, "contributing": 8}


def test_norm_gaps():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0}
    prog = {"a": 1.1, "b": 2.0, "c": 4.0}
    # leaf a: |1.1 - 1| / max(1, median 2) = 0.05
    assert compare.norm_gap(prog, ref, ["a", "b", "c"]) == (
        pytest.approx(0.05), "a")
    nums = compare.train_numbers(
        {"losses": [1.1, 2.0], "grad": ref, "delta": {"a": 0.0, "b": 2.0,
                                                      "c": 4.0}},
        {"losses": [1.0, 2.2], "grad": dict(ref, a=1e-4),
         "delta": {"a": 5.0, "b": 2.0, "c": 4.0}})
    # the first step's loss is compared; the later ones are only logged
    assert nums["loss_gap"]["value"] == pytest.approx(0.1)
    assert nums["later_loss_gaps"] == [pytest.approx(0.2 / 2.2)]
    # leaf a's reference gradient is under 1e-3 of the median: still,
    # and left out of the change
    assert nums["still_leaves"] == ["a"]
    assert nums["delta_gap"]["value"] == 0.0
    unchanged = compare.train_numbers(
        {"losses": [1.0], "grad": ref, "delta": {k: 0.0 for k in ref}},
        {"losses": [1.0], "grad": ref, "delta": ref})
    assert unchanged["delta_gap"]["value"] == pytest.approx(1.0)


def test_first_gradient_from_the_moment():
    import torch
    mu = {"x": torch.full((4,), 0.1 * 3.0)}
    assert compare.first_grad_norms(mu)["x"] == pytest.approx(
        math.sqrt(4) * 3.0)
