"""BENCHMARK.json against the rules of its format, and discovery by
name: every configuration, mix, limits file and metric reader it names
is found, and a new one is found from new files and entries alone."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return bench_run.load_json(os.path.join(REPO, "BENCHMARK.json"))


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in spec["command"])
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_bounds(spec):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_reports_enough(spec):
    b = bench_run.Bench(REPO)
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e = [m["name"] for m in b.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.per_layer(w["name"])


def test_discovery_by_name(spec):
    b = bench_run.Bench(REPO)
    for w in spec["workloads"]:
        cell = b.cell(w["name"])
        cfg = b.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert b.mix(cell["traffic"])["kind"] == "train"
        assert set(b.limits(w["name"])) == {"loss_gap", "grad_gap",
                                            "delta_gap"}
        assert b.runner(b.mix(cell["traffic"])["kind"]).run
        for m in b.per_layer(w["name"]):
            assert callable(b.reader(m["name"]))


def test_config_files_state_their_cuts(spec):
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = bench_run.load_json(os.path.join(REPO, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["num_pts"] == 1_500_000 and cfg["capacity"] == 1 << 21
        assert cfg["clip"]["height"] == 640 and cfg["clip"]["width"] == 960
        assert "assumed" in cfg


def test_new_entries_need_no_edit(tmp_path, spec):
    """A configuration with its own deformation field, a mix and a
    per-layer metric added as new files and new entries are found by
    name, with no existing file edited."""
    import torch

    from benchmark.frozen import fields, flops
    from benchmark.tests import toy_program, toy_reference
    from benchmark.tests.tiny import TOY_FIELD
    root = tmp_path
    bdir = root / "benchmark"
    (bdir / "configs").mkdir(parents=True)
    (bdir / "mixes").mkdir()
    (bdir / "limits").mkdir()
    (bdir / "metrics").mkdir()
    dummy = {"name": "dummy", "model": {}, "field": TOY_FIELD}
    (bdir / "configs" / "dummy.json").write_text(json.dumps(dummy))
    (bdir / "mixes" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "train"}))
    (bdir / "limits" / "dummy.dummy_mix.json").write_text(json.dumps(
        {"loss_gap": 1.0}))
    (bdir / "metrics" / "dummy_share.py").write_text(
        "def read(ctx):\n    return ctx.get('x')\n")
    new = dict(spec)
    new["configs"] = spec["configs"] + [{
        "name": "dummy", "source": "https://example.org", "reduced": [],
        "file": "benchmark/configs/dummy.json", "why": "a test"}]
    new["workloads"] = spec["workloads"] + [{
        "name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix",
        "chips": 1, "why": "a test"}]
    new["per_layer"] = spec["per_layer"] + [{
        "name": "dummy_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "a test",
        "moves": "train_views_per_s", "workloads": ["dummy.dummy_mix"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    b = bench_run.Bench(str(root))
    config = b.config("dummy")
    assert config == dummy
    gen = torch.Generator().manual_seed(0)
    assert isinstance(fields.program(config, None, gen, "cpu"),
                      toy_program.ToyField)
    assert isinstance(fields.reference(config, None, gen, "cpu"),
                      toy_reference.ToyReference)
    assert flops.train_step(config, 1, 0, 0, 0, [], 0) == (
        3 * toy_reference.row_ops({}, TOY_FIELD["params"]))
    assert b.mix("dummy_mix") == {"kind": "train"}
    assert b.limits("dummy.dummy_mix") == {"loss_gap": 1.0}
    assert [m["name"] for m in b.per_layer("dummy.dummy_mix")] == [
        "dummy_share"]
    assert b.reader("dummy_share")({"x": 7.0}) == 7.0
    assert "dummy_share" not in [m["name"] for m in b.per_layer(
        spec["workloads"][0]["name"])]
