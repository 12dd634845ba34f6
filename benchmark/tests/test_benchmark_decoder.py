"""The deformation field decoder's metrics (``field_mlp_ms.train``,
``field_mlp_roofline``) and the cell ``waymo_4dgs.train``: the decoder's
counts against hand counts at ``defor_depth`` 0 and 1, the readers on a
hand-made span record and the cell's configuration (nothing from a
program without the inner spans, nor for a configuration that names
another field), the entries of ``BENCHMARK.json`` that came with the
cell, and a tiny run of the cell on the CPU."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from benchmark.frozen import flops
from benchmark.metrics import _mlp_work as mw
from benchmark.run import Bench, execute
from benchmark.tests.tiny import REPO, tiny_tree
from s3gaussian_tpu_torch.utils import spans

CELLS = ["waymo_default.train", "waymo_perf.train", "waymo_4dgs.train"]


def model(name):
    return Bench(REPO).config(name)["model"]


ON_CARD = {"busy_s": 1.5, "window_s": 2.0,
           "config": Bench(REPO).config("waymo_4dgs")}


def test_counts_at_depth_0():
    """waymo_4dgs: Linear(32,128), five heads of Linear(128,128) and
    Linear(128, 3 / 3 / 4 / 1 / 48), no DINO head."""
    m = model("waymo_4dgs")
    assert flops.decoder_linears(m) == [(32, 128)] + [
        p for o in (3, 3, 4, 1, 48) for p in ((128, 128), (128, o))]
    ops = (2 * 32 * 128 + 128) + 5 * (2 * 128 * 128 + 128) + sum(
        2 * 128 * o + o for o in (3, 3, 4, 1, 48)) + (3 + 3 + 4 + 1 + 48)
    assert mw.row_ops(m) == ops == 188_022
    assert mw.row_bytes(m) == 4 * (160 + 5 * 256 + 131 + 131 + 132 + 129
                                   + 176) == 8_556
    assert mw.weight_bytes(m) == 4 * (4224 + 5 * 16512 + 387 + 387 + 516
                                      + 129 + 6192) == 377_580
    rows = 2_097_152
    assert mw.step_least_s(m, rows) == pytest.approx(
        3 * rows * ops / 67e12)           # bound by operations
    # the step's count takes max(D - 1, 0) Linear(W, W) into feature_out,
    # the decoder's own layers: none at D = 0, as at D = 1
    assert flops.field_forward(m) == flops.field_forward(
        dict(m, defor_depth=1)) == 189_215


def test_counts_at_depth_1_and_2():
    """waymo_default: Linear(128,64), the pos and shs heads at W=64, the
    DINO head; one more Linear(W,W) a level of depth past 1."""
    m = model("waymo_default")
    assert flops.decoder_linears(m) == [(128, 64), (64, 64), (64, 3), (64, 64),
                             (64, 48), (64, 64), (64, 64), (64, 3)]
    assert mw.row_ops(m) == (16_448 + 2 * 8_256 + 387 + 6_192 + 8_256
                             + 8_256 + 387 + 3 + 48) == 56_489
    assert mw.row_bytes(m) == 4 * (192 + 128 + 67 + 128 + 112 + 128 + 128
                                   + 67) == 3_800
    deeper = dict(m, defor_depth=2)
    assert flops.decoder_linears(deeper)[:3] == [(128, 64), (64, 64),
                                                 (64, 64)]
    assert mw.row_ops(deeper) - mw.row_ops(m) == 2 * 64 * 64 + 64
    rows = 2_097_152
    assert mw.step_least_s(m, rows) == pytest.approx(
        3 * (rows * 3_800 + mw.weight_bytes(m)) / 3.35e12)  # by bytes


def inner_block(ns_rows, field_rows):
    n = len(ns_rows)
    return {"span_ns": torch.zeros(n, len(spans.NAMES), dtype=torch.int64),
            "inner_ns": torch.tensor(ns_rows, dtype=torch.int64),
            "field_rows": torch.tensor(field_rows, dtype=torch.int32),
            "visible_rows": torch.zeros(n, dtype=torch.int32)}


@pytest.fixture
def record(monkeypatch):
    """Two kept blocks: three steps of 40 + 60 ms of decoder."""
    monkeypatch.setattr(spans, "_traced", [])
    spans.keep(inner_block([[40_000_000, 60_000_000]] * 2,
                           [2_097_152, 2_097_152]))
    spans.keep(inner_block([[30_000_000, 60_000_000]], [1_048_576]))
    return monkeypatch


def read(metric, ctx=ON_CARD):
    return Bench(REPO).reader(metric)(dict(ctx))


def test_readers(record):
    assert read("field_mlp_ms.train") == pytest.approx(290.0 / 3)
    m = model("waymo_4dgs")
    least = 2 * mw.step_least_s(m, 2_097_152) + mw.step_least_s(m, 1_048_576)
    assert read("field_mlp_roofline") == pytest.approx(
        100.0 * least / 0.290)
    # the widths are the cell's: another configuration's decoder reads
    # its own least time; one that names another field, or none, nothing
    d = Bench(REPO).config("waymo_default")
    least_d = (2 * mw.step_least_s(d["model"], 2_097_152)
               + mw.step_least_s(d["model"], 1_048_576))
    assert read("field_mlp_roofline", dict(ON_CARD, config=d)) == (
        pytest.approx(100.0 * least_d / 0.290))
    other = dict(ON_CARD["config"], field={"program": "a:b"})
    assert read("field_mlp_roofline", dict(ON_CARD, config=other)) is None
    no_config = {k: v for k, v in ON_CARD.items() if k != "config"}
    assert read("field_mlp_roofline", no_config) is None


@pytest.mark.parametrize("metric", ["field_mlp_ms.train",
                                    "field_mlp_roofline"])
def test_nothing_without_inner_spans(record, metric):
    assert read(metric) is not None
    assert read(metric, dict(ON_CARD, busy_s=0.0)) is None
    # a program whose steps carry no inner spans (the parent's)
    kept = [{k: v for k, v in b.items() if k != "inner_ns"}
            for b in spans._traced]
    record.setattr(spans, "_traced", kept)
    record.setattr(spans, "KEYS", ("span_ns", "field_rows", "visible_rows"))
    assert read(metric) is None
    # a program without the span record
    import s3gaussian_tpu_torch.utils as utils
    record.delattr(utils, "spans")
    record.setitem(sys.modules, "s3gaussian_tpu_torch.utils.spans", None)
    assert read(metric) is None


def _before(cells, earlier, later):
    """Each of ``earlier`` that ``cells`` lists comes before ``later``."""
    return all(cells.index(c) < cells.index(later) for c in earlier
               if c in cells)


def test_new_entries_in_benchmark_json():
    """The entries that came with the cell, wherever later entries put
    them."""
    b = Bench(REPO)
    config = {c["name"]: c for c in b.spec["configs"]}["waymo_4dgs"]
    assert config == {
        "name": "waymo_4dgs",
        "source": "https://github.com/hustvl/4DGaussians arguments/dynerf/"
                  "default.py (ModelHiddenParams) on the S3Gaussian Waymo "
                  "clip of waymo_default",
        "file": "benchmark/configs/waymo_4dgs.json", "reduced": [],
        "why": config["why"]}
    cell = b.cell("waymo_4dgs.train")
    assert {k: cell[k] for k in ("name", "config", "traffic", "chips")} == {
        "name": "waymo_4dgs.train", "config": "waymo_4dgs",
        "traffic": "train", "chips": 1}
    assert len(cell["why"]) <= 200
    names = [m["name"] for m in b.spec["per_layer"]]
    assert names.index("field_mlp_roofline") == names.index(
        "field_mlp_ms.train") + 1
    got = {m["name"]: m for m in b.spec["per_layer"]}
    assert got["field_mlp_ms.train"]["workloads"][:3] == CELLS
    assert got["field_mlp_roofline"]["workloads"][:1] == ["waymo_4dgs.train"]
    for name in ("field_mlp_ms.train", "field_mlp_roofline"):
        assert got[name]["layer"] == got["field_ms.train"]["layer"]
        assert got[name]["moves"] == "train_views_per_s"
    # the cell was appended to the lists it reports, the others kept
    for m in b.spec["end_to_end"] + b.spec["per_layer"]:
        if "workloads" in m and "waymo_4dgs.train" in m["workloads"]:
            assert _before(m["workloads"], CELLS[:2], "waymo_4dgs.train")
    # what the cell reported when it came; later entries may add to it
    reported = {m["name"] for m in b.per_layer("waymo_4dgs.train")}
    assert reported >= {
        "device_idle.train", "mfu.train", "composite_bwd_roofline",
        "segment_sum_roofline", "pairs_per_view.train", "field_ms.train",
        "raster_ms.train", "loss_ms.train", "update_ms.train",
        "field_yield.train", "pool_init_s.train", "capture_s.train",
        "field_mlp_ms.train", "field_mlp_roofline"}
    assert {m["name"] for m in b.end_to_end("waymo_4dgs.train")} >= {
        "train_views_per_s", "peak_mem_gib", "setup_s"}


def test_tiny_run_of_the_cell(tmp_path):
    """The cell at a tiny size on the CPU, traced: correct, the shares of
    device time read nothing without a card.  5,000 points: above 4,096
    the program's KNN is the native search that the reference follows,
    as at the cell's 1.5 M (below, its numpy search differs on a few
    rows' initial scales)."""
    bench = tiny_tree(str(tmp_path))
    path = tmp_path / "benchmark" / "configs" / "waymo_4dgs.json"
    cfg = json.loads(path.read_text())
    cfg.update(num_pts=5000, capacity=8192)
    cfg["raster"]["max_visible"] = 8192
    path.write_text(json.dumps(cfg))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = execute(bench, "waymo_4dgs.train", 2 ** 31 + 777, 0.0, True,
                      "cpu")
    finally:
        torch.set_num_threads(n)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"mfu.train", "pairs_per_view.train"}
