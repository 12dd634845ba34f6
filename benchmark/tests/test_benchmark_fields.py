"""A configuration names its deformation field (``benchmark/frozen/
fields.py``): without ``"field"`` the hexplane field, program and
reference drawn alike; with one, a toy gridless field added as new
files and entries only runs through ``run.execute`` on the CPU,
``correct`` and with ``mfu.train``, and reads ``correct`` false with
its program broken underneath."""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench_run
from benchmark.frozen import fields, flops, reference
from benchmark.harness.train import _program_settings
from benchmark.tests import toy_program
from benchmark.tests.tiny import REPO, TOY_FIELD, toy_tree

SEED = 2 ** 31 + 4242


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_grid(config):
    model = dict(config["model"], multires=[1, 2], kplanes_config=dict(
        config["model"]["kplanes_config"], resolution=[8, 8, 8, 5]))
    return dict(config, model=model)


def _both(config, seed=7):
    """The program's and the reference's field of ``config`` from one
    seed, on the CPU."""
    prog = fields.program(config, _program_settings(config)[0],
                          torch.Generator().manual_seed(seed), "cpu")
    ref = fields.reference(config, reference.settings(config)[0],
                           torch.Generator().manual_seed(seed), "cpu")
    return prog, ref


def _same_parameters(prog, ref):
    a, b = prog.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for g in ("grid", "deformation"):
        assert list(prog.param_groups()[g]) == list(ref.param_groups()[g])


@pytest.mark.parametrize("name", ["waymo_default", "waymo_perf",
                                  "waymo_4dgs"])
def test_without_a_field_the_hexplane(name):
    from benchmark.frozen.ref.models import deformation as frozen
    from s3gaussian_tpu_torch.models import deformation as port
    config = bench_run.Bench(REPO).config(name)
    assert "field" not in config and fields.entry(config) == fields.HEXPLANE
    assert fields.row_ops(config) == flops.field_forward(config["model"])
    prog, ref = _both(_tiny_grid(config))
    assert type(prog) is port.DeformationField
    assert type(ref) is frozen.DeformationField
    _same_parameters(prog, ref)


def test_toy_sides_agree():
    config = dict(bench_run.Bench(REPO).config("waymo_default"),
                  field=TOY_FIELD)
    prog, ref = _both(config)
    _same_parameters(prog, ref)
    assert not prog.param_groups()["grid"]
    g = torch.Generator().manual_seed(1)
    xyz = torch.randn(64, 3, generator=g) * 5
    args = (xyz, *(torch.randn(64, *s, generator=g)
                   for s in ((3,), (4,), (1,), (16, 3))),
            torch.tensor(0.3), None)
    a, b = prog(*args), ref(*args)
    torch.testing.assert_close(a.dx, b.dx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a.xyz, b.xyz, rtol=1e-5, atol=1e-6)
    assert a.feat is a.dshs is b.feat is b.dshs is None
    # 3 a coordinate an octave, Linear(20, 16), Linear(36, 16),
    # Linear(16, 3), the residual add
    assert fields.row_ops(config) == (3 * (3 * 2 + 2) + (2 * 20 * 16 + 16)
                                      + (2 * 36 * 16 + 16) + (2 * 16 * 3 + 3)
                                      + 3) == 1_950


def test_a_field_lacking_a_role_is_refused():
    for role in ("program", "reference", "work", "params"):
        config = {"model": {}, "field": {k: v for k, v in TOY_FIELD.items()
                                         if k != role}}
        with pytest.raises(KeyError, match=role):
            fields.row_ops(config)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_tree(str(tmp_path_factory.mktemp("toy")))


def _run(bench):
    return bench_run.execute(bench, "toy.train", SEED, 0.0, True, "cpu")


def test_toy_field_run_is_correct(toy):
    assert toy.config("toy")["field"] == TOY_FIELD
    out = _run(toy)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"mfu.train"}
    assert out["metrics"]["mfu.train"]["value"] > 0


def _skip_dropped(monkeypatch):
    monkeypatch.setattr(toy_program.ToyField, "skip", lambda self, h, x: (
        torch.cat([h, torch.zeros_like(x)], dim=-1)))


def _draws_shifted(monkeypatch):
    real = toy_program.build

    def shifted(hp, params, generator, device):
        torch.rand(1, generator=generator)
        return real(hp, params, generator, device)

    monkeypatch.setattr(toy_program, "build", shifted)


@pytest.mark.parametrize("fault", [_skip_dropped, _draws_shifted],
                         ids=["skip_dropped", "draws_shifted"])
def test_toy_program_broken_is_not_correct(toy, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(toy)
    assert out["correct"] is False, out["checks"]

