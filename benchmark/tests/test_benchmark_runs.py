"""A whole run on the CPU at a tiny size, past the harness's look for a
card: the result line's shape and, with the timed path broken
underneath, ``correct`` false for each fault a training cell can have
on one chip (a step that returns its state unchanged; half of a rig
left out, the mean taken over the rest)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_tree

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
E2E = {"train_views_per_s", "peak_mem_gib", "setup_s"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny")))


def _run(bench, workload, trace=False):
    return bench_run.execute(bench, workload, SEED, 0.0, trace, "cpu")


def test_result_line_single_camera(bench):
    out = _run(bench, "waymo_default.train")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 10
    assert set(out["metrics"]) == E2E
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "delta_gap"}
    json.dumps(out)


def test_traced_rig_run_reports_layers(bench):
    out = _run(bench, "waymo_perf.train", trace=True)
    assert out["correct"] is True
    # no device on the CPU: the shares of device time read nothing
    assert set(out["metrics"]) == {"mfu.train", "pairs_per_view.train"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


def test_state_left_unchanged_is_not_correct(bench, monkeypatch):
    from s3gaussian_tpu_torch.train import trainer
    real = trainer.train_step

    def unchanged(state, *args, **kw):
        _, aux = real(trainer.reinit_optimizer(_copy(state)), *args, **kw)
        return state, aux

    monkeypatch.setattr(trainer, "train_step", unchanged)
    out = _run(bench, "waymo_default.train")
    assert out["correct"] is False
    assert out["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_half_the_rig_is_not_correct(bench, monkeypatch):
    from s3gaussian_tpu_torch.train import trainer
    real = trainer.train_step_multicam

    def half(state, cameras, *args, **kw):
        cams = list(cameras)
        return real(state, cams[:len(cams) - len(cams) // 2], *args, **kw)

    monkeypatch.setattr(trainer, "train_step_multicam", half)
    out = _run(bench, "waymo_perf.train")
    assert out["correct"] is False


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "waymo_default.train", "--seed",
                         str(SEED), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def _copy(state):
    from s3gaussian_tpu_torch.train.graphs import clone_state
    return clone_state(state)
