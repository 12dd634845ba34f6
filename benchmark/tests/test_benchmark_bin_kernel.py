"""``bin_kernel.train`` on hand-made span records: Σ ``bins_kernel`` /
Σ (``raster_passes`` − ``bins_reused``) over the kept steps in %, the
share of the steps' own binnings whose keys the emission kernel wrote;
nothing where the program counts no ``bins_kernel`` (a program before
the kernel), bins nothing, has no record, or ran nothing on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark.run import Bench
from benchmark.tests.tiny import REPO
from s3gaussian_tpu_torch.utils import spans

ON_CARD = {"busy_s": 1.5, "window_s": 2.0}
CELLS = ["waymo_default.train", "waymo_perf.train", "waymo_4dgs.train",
         "waymo_d3dgs.train"]


def block(passes, reused, kernel=None):
    n = len(passes)
    out = {"span_ns": torch.ones(n, len(spans.NAMES), dtype=torch.int64),
           "field_rows": torch.full((n,), 1000, dtype=torch.int32),
           "visible_rows": torch.full((n,), 300, dtype=torch.int32),
           "raster_passes": torch.tensor(passes, dtype=torch.int32),
           "bins_reused": torch.tensor(reused, dtype=torch.int32)}
    if kernel is not None:
        out["bins_kernel"] = torch.tensor(kernel, dtype=torch.int32)
    return out


def read(ctx=ON_CARD):
    return Bench(REPO).reader("bin_kernel.train")(dict(ctx))


@pytest.fixture
def kept(monkeypatch):
    monkeypatch.setattr(spans, "_traced", [])
    return spans.keep


@pytest.mark.parametrize("blocks,want", [
    ([([6, 6], [3, 3], [3, 3]), ([6], [3], [3])], 100.0),  # rigs, feature
    ([([1, 1], [0, 0], [1, 1])], 100.0),                   # single pass
    ([([2, 2, 2], [1, 1, 1], [0, 0, 0])], 0.0),            # the CPU
    ([([6], [3], [3]), ([3, 3], [0, 0], [0, 0])], 33.333333333333336),
])
def test_share_of_binnings_the_kernel_emitted(kept, blocks, want):
    for passes, reused, kernel in blocks:
        kept(block(passes, reused, kernel))
    assert read() == pytest.approx(want)


def test_nothing_without_the_tally(kept, monkeypatch):
    kept(block([6], [3]))                  # a program before the kernel
    assert read() is None
    monkeypatch.setattr(spans, "_traced", [])
    assert read() is None                  # no record
    kept(block([6], [3], [3]))
    assert read({"busy_s": 0.0, "window_s": 2.0}) is None
    assert read({}) is None
    monkeypatch.setattr(spans, "_traced", [])
    kept(block([2], [2], [0]))             # every pass reused: no binning
    assert read() is None


def test_entry_in_benchmark_json():
    b = Bench(REPO)
    entries = [m for m in b.spec["per_layer"]
               if m["name"] == "bin_kernel.train"]
    assert entries == [{"name": "bin_kernel.train", "unit": "%",
                        "better": "higher", "source": "program_counter",
                        "layer": "rasterizer", "moves": "train_views_per_s",
                        "workloads": CELLS}]
    for cell in CELLS:
        assert "bin_kernel.train" in {m["name"] for m in b.per_layer(cell)}
