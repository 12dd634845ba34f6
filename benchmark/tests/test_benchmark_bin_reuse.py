"""``bin_reuse.train`` on hand-made span records: Σ ``bins_reused`` /
Σ ``raster_passes`` over the kept steps in %, 0 for single-pass steps,
and nothing where the program counts neither (a program before the
counters), has no record, or ran nothing on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark.run import Bench
from benchmark.tests.tiny import REPO
from s3gaussian_tpu_torch.utils import spans

ON_CARD = {"busy_s": 1.5, "window_s": 2.0}
CELLS = ["waymo_default.train", "waymo_perf.train", "waymo_4dgs.train"]


def block(passes, reused, tallies=True):
    n = len(passes)
    out = {"span_ns": torch.ones(n, len(spans.NAMES), dtype=torch.int64),
           "field_rows": torch.full((n,), 1000, dtype=torch.int32),
           "visible_rows": torch.full((n,), 300, dtype=torch.int32)}
    if tallies:
        out["raster_passes"] = torch.tensor(passes, dtype=torch.int32)
        out["bins_reused"] = torch.tensor(reused, dtype=torch.int32)
    return out


def read(ctx=ON_CARD):
    return Bench(REPO).reader("bin_reuse.train")(dict(ctx))


@pytest.fixture
def kept(monkeypatch):
    monkeypatch.setattr(spans, "_traced", [])
    return spans.keep


@pytest.mark.parametrize("blocks,want", [
    ([([6, 6], [3, 3]), ([6], [3])], 50.0),      # rigs of 3, feature pass
    ([([2, 2, 2], [1, 1, 1])], 50.0),            # a camera, feature pass
    ([([1, 1], [0, 0])], 0.0),                   # single pass
    ([([6], [3]), ([3, 3], [0, 0])], 25.0),      # summed, not averaged
])
def test_share_of_reused_binnings(kept, blocks, want):
    for passes, reused in blocks:
        kept(block(passes, reused))
    assert read() == pytest.approx(want)


def test_nothing_without_the_counters(kept, monkeypatch):
    kept(block([6], [3], tallies=False))
    assert read() is None
    monkeypatch.setattr(spans, "_traced", [])
    assert read() is None
    kept(block([6], [3]))
    assert read({"busy_s": 0.0, "window_s": 2.0}) is None
    assert read({}) is None
    kept(block([0], [0]))
    assert read() == pytest.approx(50.0)


def test_entry_in_benchmark_json():
    b = Bench(REPO)
    entry = b.spec["per_layer"][-1]
    assert entry == {"name": "bin_reuse.train", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "rasterizer", "moves": "train_views_per_s",
                     "workloads": CELLS}
    for cell in CELLS:
        assert "bin_reuse.train" in {m["name"] for m in b.per_layer(cell)}
