"""The readers of the program's spans and counters on a hand-made span
record: each reads what its docstring says, and returns None where the
record has no such span (the cull and the budget of ``waymo_default``),
where the program has no record, and in a run without device activity.
Beside them, the new ``per_layer`` entries of ``BENCHMARK.json`` as the
cells report them."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark.run import Bench
from benchmark.tests.tiny import REPO
from s3gaussian_tpu_torch.utils import spans

ON_CARD = {"busy_s": 1.5, "window_s": 2.0}
BOTH = ["waymo_default.train", "waymo_perf.train"]
NEW = {  # name: (unit, better, source, layer, moves, workloads)
    "field_ms.train": ("ms", "lower", "program_span", "deformation field",
                       "train_views_per_s", BOTH),
    "raster_ms.train": ("ms", "lower", "program_span", "rasterizer",
                        "train_views_per_s", BOTH),
    "loss_ms.train": ("ms", "lower", "program_span", "train step",
                      "train_views_per_s", BOTH),
    "update_ms.train": ("ms", "lower", "program_span", "train step",
                        "train_views_per_s", BOTH),
    "cull_ms.train": ("ms", "lower", "program_span", "render, cull",
                      "train_views_per_s", ["waymo_perf.train"]),
    "field_yield.train": ("%", "higher", "program_counter", "render, cull",
                          "train_views_per_s", BOTH),
    "pool_init_s.train": ("s", "lower", "program_span", "pool", "setup_s",
                          BOTH),
    "budget_s.train": ("s", "lower", "program_span", "render, cull",
                       "setup_s", ["waymo_perf.train"]),
    "capture_s.train": ("s", "lower", "program_span", "dispatch", "setup_s",
                        BOTH),
}


def span_ns(**ms):
    row = torch.zeros(len(spans.NAMES), dtype=torch.int64)
    for name, v in ms.items():
        row[spans.NAMES.index(name.replace("_", "."))] = int(v * 1e6)
    return row


def block(rows, field_rows, visible_rows):
    return {"span_ns": torch.stack(rows),
            "field_rows": torch.tensor(field_rows, dtype=torch.int32),
            "visible_rows": torch.tensor(visible_rows, dtype=torch.int32)}


@pytest.fixture
def record(monkeypatch):
    """Two kept blocks of a culled rig cell (three steps) and its set-up's
    host spans."""
    monkeypatch.setattr(spans, "_traced", [])
    monkeypatch.setattr(spans, "_host", [
        spans.HostSpan("pool.init", None, 0, 2_500_000_000),
        spans.HostSpan("pool.knn", "pool.init", 0, 2_000_000_000),
        spans.HostSpan("budget", None, 3_000_000_000, 8_000_000_000),
        spans.HostSpan("graph.warmup", None, 9_000_000_000, 10_500_000_000),
        spans.HostSpan("graph.capture", None, 10_500_000_000,
                       11_000_000_000),
        spans.HostSpan("graph.capture", None, 12_000_000_000)])  # not ended
    step = dict(cull=4, field_fwd=50, field_bwd=90, project_fwd=10,
                bin_fwd=20, composite_fwd=1, loss_fwd=8, loss_bwd=6,
                composite_bwd=3, bin_bwd=5, project_bwd=12, update=15)
    spans.keep(block([span_ns(**step)] * 2, [1000, 1000], [300, 500]))
    spans.keep(block([span_ns(**{**step, "update": 18})], [1000], [400]))
    return monkeypatch


def read(metric, ctx=ON_CARD):
    return Bench(REPO).reader(metric)(dict(ctx))


def test_device_span_readers(record):
    assert read("field_ms.train") == pytest.approx(140.0)
    assert read("raster_ms.train") == pytest.approx(51.0)
    assert read("loss_ms.train") == pytest.approx(14.0)
    assert read("update_ms.train") == pytest.approx(16.0)
    assert read("cull_ms.train") == pytest.approx(4.0)
    assert read("field_yield.train") == pytest.approx(40.0)


def test_host_span_readers(record):
    assert read("pool_init_s.train") == pytest.approx(2.5)
    assert read("budget_s.train") == pytest.approx(5.0)
    assert read("capture_s.train") == pytest.approx(2.0)


def test_no_cull_and_no_budget_read_nothing(monkeypatch):
    """``waymo_default``: no step culls, the budget is set, not sized."""
    monkeypatch.setattr(spans, "_traced", [])
    monkeypatch.setattr(spans, "_host", [
        spans.HostSpan("pool.init", None, 0, 10)])
    spans.keep(block([span_ns(field_fwd=5, update=1)], [2048], [512]))
    assert read("cull_ms.train") is None
    assert read("budget_s.train") is None
    assert read("field_ms.train") == pytest.approx(5.0)
    assert read("field_yield.train") == pytest.approx(25.0)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_nothing_without_a_record_or_a_card(record, metric):
    assert read(metric) is not None
    assert read(metric, {"busy_s": 0.0, "window_s": 2.0}) is None
    assert read(metric, {}) is None
    # a program without the span record (the module is not there)
    import s3gaussian_tpu_torch.utils as utils
    record.delattr(utils, "spans")
    record.setitem(sys.modules, "s3gaussian_tpu_torch.utils.spans", None)
    assert read(metric) is None


def test_device_readers_without_a_traced_step(monkeypatch):
    monkeypatch.setattr(spans, "_traced", [])
    for m in ("field_ms.train", "raster_ms.train", "loss_ms.train",
              "update_ms.train", "cull_ms.train", "field_yield.train"):
        assert read(m) is None, m


def test_new_entries_in_benchmark_json():
    """The entries that came with the spans, in their order, wherever
    later entries put them; later cells may follow theirs."""
    b = Bench(REPO)
    got = {m["name"]: m for m in b.spec["per_layer"]}
    names = [m["name"] for m in b.spec["per_layer"]]
    first = names.index(next(iter(NEW)))
    assert names[first:first + len(NEW)] == list(NEW)
    for name, (unit, better, source, layer, moves, cells) in NEW.items():
        m = dict(got[name])
        assert m.pop("workloads")[:len(cells)] == cells
        assert m == {"name": name, "unit": unit, "better": better,
                     "source": source, "layer": layer, "moves": moves}
    for cell in BOTH:
        reported = {m["name"] for m in b.per_layer(cell)}
        want = {n for n, e in NEW.items() if cell in e[5]}
        assert want <= reported
        assert ("cull_ms.train" in reported) == (cell == "waymo_perf.train")
        assert ("budget_s.train" in reported) == (cell == "waymo_perf.train")
