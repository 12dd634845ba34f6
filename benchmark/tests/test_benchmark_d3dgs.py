"""The cell ``waymo_d3dgs.train``: Deformable 3D Gaussians' deformation
network named by its configuration's ``"field"`` (program
``benchmark/fields/deformable3dgs.py``, reference and work
``benchmark/fields/deformable3dgs_ref.py``).  Its work counts against
hand counts at the published widths; ``field_net_roofline`` on a
hand-made span record (nothing for a hexplane configuration, without a
card, or from a work module without the three counts); the entries of
``BENCHMARK.json`` that came with the cell; and a tiny run of the cell
on the CPU, ``correct``, and not with the planted fault of the limits
(the scaling delta added to the raw scale before exp)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.fields import deformable3dgs_ref as dref
from benchmark.frozen import fields
from benchmark.run import Bench, execute
from benchmark.tests.tiny import REPO, TOY_FIELD, tiny_tree
from s3gaussian_tpu_torch.utils import spans

CELL = "waymo_d3dgs.train"
EARLIER = ["waymo_default.train", "waymo_perf.train", "waymo_4dgs.train"]
CONFIG = Bench(REPO).config("waymo_d3dgs")
ON_CARD = {"busy_s": 1.5, "window_s": 2.0, "config": CONFIG}
# Linear(84, 256), 4 x Linear(256, 256), Linear(340, 256),
# 2 x Linear(256, 256), the heads Linear(256, 3 / 4 / 3)
LINEARS = ((84, 256), (256, 256), (256, 256), (256, 256), (256, 256),
           (340, 256), (256, 256), (256, 256), (256, 3), (256, 4), (256, 3))


def test_work_counts_at_the_published_widths():
    params = CONFIG["field"]["params"]
    assert dref.linears(params) == list(LINEARS)
    network = (43_264 + 4 * 131_328 + 174_336 + 2 * 131_328
               + 1_539 + 2_052 + 1_539)
    assert network == 1_010_698
    # a multiply, a sine and a cosine an octave: 3 coordinates and the
    # time at 10 octaves; the deltas' adds 3 + 3 + 4
    assert dref.row_ops(CONFIG["model"], params) == \
        network + 3 * (3 * 10 + 10) + 10 == 1_010_828
    assert fields.row_ops(CONFIG) == 1_010_828
    assert dref.row_bytes(CONFIG["model"], params) == sum(
        4 * (i + o) for i, o in LINEARS) == 19_144
    assert dref.weight_bytes(CONFIG["model"], params) == sum(
        4 * (i * o + o) for i, o in LINEARS) == 2_025_512


def inner_block(ns_rows, field_rows):
    n = len(ns_rows)
    return {"span_ns": torch.zeros(n, len(spans.NAMES), dtype=torch.int64),
            "inner_ns": torch.tensor(ns_rows, dtype=torch.int64),
            "field_rows": torch.tensor(field_rows, dtype=torch.int32),
            "visible_rows": torch.zeros(n, dtype=torch.int32)}


@pytest.fixture
def record(monkeypatch):
    """Two kept blocks: two steps of 60 + 120 ms of network over the
    pool's 2,097,152 rows, one of 50 + 100 ms over 1,048,576."""
    monkeypatch.setattr(spans, "_traced", [])
    spans.keep(inner_block([[60_000_000, 120_000_000]] * 2,
                           [2_097_152, 2_097_152]))
    spans.keep(inner_block([[50_000_000, 100_000_000]], [1_048_576]))
    return monkeypatch


def read(ctx=ON_CARD):
    return Bench(REPO).reader("field_net_roofline")(dict(ctx))


def test_field_net_roofline_reads_the_least_time(record):
    # forward and backward, 3 x the forward; compute-bound at these
    # widths: 3 x rows x 1,010,828 operations at 67 TFLOP/s against
    # 3 x (rows x 19,144 + 2,025,512) bytes at 3.35 TB/s
    def least(rows):
        return max(3 * rows * 1_010_828 / 67e12,
                   3 * (rows * 19_144 + 2_025_512) / 3.35e12)

    assert least(2_097_152) == 3 * 2_097_152 * 1_010_828 / 67e12
    want = 100.0 * (2 * least(2_097_152) + least(1_048_576)) / 0.510
    assert read() == pytest.approx(want)
    assert 0 < read() <= 100


def test_field_net_roofline_reads_nothing_elsewhere(record):
    assert read() is not None
    # no card, a hexplane configuration, a work module without the
    # bytes counts
    assert read(dict(ON_CARD, busy_s=0.0)) is None
    hexplane = Bench(REPO).config("waymo_4dgs")
    assert read(dict(ON_CARD, config=hexplane)) is None
    assert read(dict(ON_CARD, config=dict(CONFIG, field=TOY_FIELD))) is None
    # a program whose steps carry no inner spans
    record.setattr(spans, "_traced", [
        {k: v for k, v in b.items() if k != "inner_ns"}
        for b in spans._traced])
    record.setattr(spans, "KEYS", ("span_ns", "field_rows", "visible_rows"))
    assert read() is None


def test_entries_in_benchmark_json():
    b = Bench(REPO)
    config = {c["name"]: c for c in b.spec["configs"]}["waymo_d3dgs"]
    assert config["file"] == "benchmark/configs/waymo_d3dgs.json"
    assert config["reduced"] == CONFIG["reduced"] == []
    assert config["source"] == CONFIG["source"]
    assert CONFIG["field"]["program"] == \
        "benchmark.fields.deformable3dgs:program"
    cell = b.cell(CELL)
    assert {k: cell[k] for k in ("config", "traffic", "chips")} == {
        "config": "waymo_d3dgs", "traffic": "train", "chips": 1}
    assert len(cell["why"]) <= 200
    assert sum(1 for w in b.spec["workloads"] if w["chips"] == 4) == 0
    got = {m["name"]: m for m in b.spec["per_layer"]}
    net = got["field_net_roofline"]
    assert (net["workloads"], net["source"], net["moves"], net["unit"]) == (
        [CELL], "program_span", "train_views_per_s", "%")
    assert net["layer"] == got["field_mlp_ms.train"]["layer"]
    # not composite_bwd_roofline: its work counts, taken at the window's
    # last state, outrun the window's own pairs while this field's
    # Gaussians grow through it (119.9% in a traced run on the card)
    assert {m["name"] for m in b.per_layer(CELL)} == {
        "device_idle.train", "mfu.train", "pairs_per_view.train",
        "field_ms.train", "raster_ms.train", "loss_ms.train", "update_ms.train", "field_yield.train",
        "pool_init_s.train", "capture_s.train", "field_mlp_ms.train",
        "bin_reuse.train", "field_net_roofline"}
    assert {m["name"] for m in b.end_to_end(CELL)} == {
        "train_views_per_s", "peak_mem_gib", "setup_s"}
    # appended after the earlier cells
    for m in b.spec["end_to_end"] + b.spec["per_layer"]:
        if CELL in m.get("workloads", []) and m is not net:
            assert m["workloads"][:len(EARLIER)] == EARLIER, m["name"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny tree with the cell at 5,000 points: above 4,096 the
    program's KNN is the native search that the reference follows."""
    root = tmp_path_factory.mktemp("d3dgs")
    bench = tiny_tree(str(root))
    path = root / "benchmark" / "configs" / "waymo_d3dgs.json"
    cfg = json.loads(path.read_text())
    cfg.update(num_pts=5000, capacity=8192)
    cfg["raster"]["max_visible"] = 8192
    path.write_text(json.dumps(cfg))
    return bench


def _run(bench, trace):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return execute(bench, CELL, 2 ** 31 + 2323, 0.0, trace, "cpu")
    finally:
        torch.set_num_threads(n)


def test_tiny_run_of_the_cell(tiny):
    out = _run(tiny, True)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    # no card: the device shares and the span readers read nothing
    assert set(out["metrics"]) == {"mfu.train", "pairs_per_view.train"}


def test_tiny_run_with_the_planted_fault_is_not_correct(tiny, monkeypatch):
    from s3gaussian_tpu_torch.models.deform_mlp import DeformMLP
    real = DeformMLP.forward

    def delta_before_exp(self, *args):
        out = real(self, *args)
        return out._replace(scales=out.scales + out.d_scales, d_scales=None)

    monkeypatch.setattr(DeformMLP, "forward", delta_before_exp)
    out = _run(tiny, False)
    assert out["correct"] is False, out["checks"]
