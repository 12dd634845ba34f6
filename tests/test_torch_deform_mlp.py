"""Deformable 3D Gaussians' deformation network (``models/deform_mlp.py``:
8 Linear(., 256) + ReLU on the encodings of the detached position and
the time, the encodings concatenated again after the fifth layer, deltas
added after activation) through the port's normal path.

On the CPU: the port's field and the benchmark's plain reference
(``benchmark/fields/deformable3dgs_ref.py``) draw the same parameters
from one seed; at the published widths over a few thousand rows the
activated attributes and every gradient agree, rows whose scale sums
below zero included, and three planted faults do not; the preset
(``arguments/waymo_d3dgs.py``) equals the benchmark's configuration, and
one eager fine step from it matches the plain reference
(``benchmark/frozen/reference.py``) in the loss and in every leaf's
gradient; the training CLI trains both stages with density control from
the preset, saves, resumes, rebuilds the field for ``--eval_only`` and
the offline tools, and runs the sweep.  The repairs beside it: the
hexplane regularisers run only for a field with a grid, and the JAX
interchange refuses a field it cannot hold.  On the card (``cuda``,
skipped without one): replays of the captured step against as many
eager steps, bit for bit.

The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_deform_mlp.py
"""

import ast
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.fields import deformable3dgs_ref as dref
from s3gaussian_tpu_torch import train_cli
from s3gaussian_tpu_torch.config import (FieldParams, ModelHiddenParams,
                                         ModelParams, OptimizationParams,
                                         PipelineParams, apply_config_file)
from s3gaussian_tpu_torch.models import deform_mlp
from s3gaussian_tpu_torch.models.deform_mlp import DeformMLP
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.fields import build_field

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(REPO, "arguments", "waymo_d3dgs.py")
LPIPS_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                             "lpips_alex_fixture.npz")
SEED = 2 ** 31 + 2242          # larger than 32 signed bits hold
PUBLISHED = FieldParams(field_kind="deformable3dgs")
# float32 on the CPU on both sides, the same operations in the same
# order but for the reference's log|u| before the renderer's exp and
# its second normalisation of a unit quaternion (an ulp or two of a
# scale or a quaternion): a part in 1e5 of a leaf's largest entry, 1e-4
# of each entry; a loss to a few float32 ulps
ATOL_SCALE, RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-6
# through a whole step those ulps can move a pixel-pair across one of the
# compositor's cutoffs and change a few entries of a gradient beyond
# rounding, so a step's gradient of a leaf is held by the norm of its
# difference: 2e-4 of its norm (the worst seen, the screen tap's, 4.5e-5)
STEP_GRAD_RTOL = 2e-4


def bench_config():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "waymo_d3dgs.json")) as f:
        return json.load(f)


def preset():
    model, pipe, opt, hp, fp = (ModelParams(), PipelineParams(),
                                OptimizationParams(), ModelHiddenParams(),
                                FieldParams())
    apply_config_file(PRESET, model, pipe, opt, hp, None, fp)
    return model, pipe, opt, hp, fp


def both_fields(fp: FieldParams, seed: int = 7):
    prog = build_field(ModelHiddenParams(), fp,
                       torch.Generator().manual_seed(seed), "cpu")
    ref = dref.build(None, dataclasses.asdict(fp),
                     torch.Generator().manual_seed(seed), "cpu")
    return prog, ref


def agree(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every entry within ATOL_SCALE of the largest of ``want`` plus
    RTOL of itself."""
    scale = float(want.abs().max())
    return bool(((got - want).abs()
                 <= ATOL_SCALE * scale + RTOL * want.abs()).all())


# --------------------------------------------------------------------------
# the field against the plain reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fp", [
    PUBLISHED,
    FieldParams(field_kind="deformable3dgs", field_depth=4, field_width=32,
                field_multires=3, field_t_multires=2, field_skip=2)],
    ids=["published", "small"])
def test_builders_draw_the_same_parameters(fp):
    prog, ref = both_fields(fp)
    a, b = prog.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    assert list(prog.param_groups()["deformation"]) == list(a)
    assert not prog.param_groups()["grid"]
    skip = fp.field_skip + 1
    n_in = 3 * (1 + 2 * fp.field_multires) + 1 + 2 * fp.field_t_multires
    assert a[f"linear.{skip}.weight"].shape == (fp.field_width,
                                                fp.field_width + n_in)
    assert len(prog.linear) == fp.field_depth
    # nn.Linear's default init: every draw within 1/sqrt(fan_in)
    for name, p in prog.named_parameters():
        owner = prog.get_submodule(name.rsplit(".", 1)[0])
        assert float(p.detach().abs().max()) <= 1 / np.sqrt(
            owner.in_features), name


def rows(n: int = 3000, seed: int = 3):
    """Raw attributes of ``n`` rows; a third with exp(s) about 1e-3, so
    that exp(s) + d_scaling falls below zero on some of them."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(n, 3, generator=g) * 4
    scales = torch.randn(n, 3, generator=g) * 0.5 - 2.0
    scales[: n // 3] = -7.0
    rot = torch.randn(n, 4, generator=g)
    return xyz, scales, rot, torch.randn(n, 1, generator=g)


def attribute_gaps(prog, ref):
    """The port's activated attributes (``renderer._attributes``) and the
    reference's (the frozen renderer's, on the raw attributes it
    returns) under one loss over positions and covariances: (the values'
    agreement, each gradient's agreement by leaf, the share of rows whose
    scale sums below zero)."""
    from benchmark.frozen.ref.models.pool import GaussianPool as RefPool
    from benchmark.frozen.ref.ops.project import build_cov3d as ref_cov
    from benchmark.frozen.ref.render import renderer as ref_renderer
    from s3gaussian_tpu_torch.models.pool import GaussianPool
    from s3gaussian_tpu_torch.ops.project import build_cov3d
    from s3gaussian_tpu_torch.render import renderer

    xyz, scales, rot, op = rows()
    n = xyz.shape[0]
    w = torch.Generator().manual_seed(5)
    w_xyz, w_cov = (torch.randn(n, 3, generator=w),
                    torch.randn(n, 6, generator=w))
    t = torch.tensor(0.37)
    out = {}
    for side, field, pool_cls, attributes, cov in (
            ("port", prog, GaussianPool, renderer._attributes, build_cov3d),
            ("ref", ref, RefPool, ref_renderer._attributes, ref_cov)):
        leaves = [x.clone().requires_grad_(True) for x in (xyz, scales, rot)]
        pool = pool_cls(xyz=leaves[0], features_dc=torch.zeros(n, 1, 3),
                        features_rest=torch.zeros(n, 15, 3),
                        scaling=leaves[1], rotation=leaves[2], opacity=op,
                        alive=torch.ones(n, dtype=torch.bool))
        x, s, r = attributes(pool, field, t, None, "fine")[:3]
        loss = (w_xyz * x).sum() + (w_cov * cov(s, r)).sum()
        params = dict(field.named_parameters())
        grads = torch.autograd.grad(loss, leaves + list(params.values()))
        names = ["pool.xyz", "pool.scaling", "pool.rotation"] + list(params)
        out[side] = (x, s, r / torch.linalg.norm(r, dim=-1, keepdim=True),
                     dict(zip(names, grads)))
    (px, ps, pr, pg), (rx, rs, rr, rg) = out["port"], out["ref"]
    values = agree(px, rx) and agree(ps.abs(), rs) and agree(pr, rr)
    return values, {k: agree(pg[k], rg[k]) for k in rg}, \
        float((ps < 0).any(-1).float().mean())


def test_attributes_and_gradients_match_the_reference():
    prog, ref = both_fields(PUBLISHED)
    values, grads, negative = attribute_gaps(prog, ref)
    assert negative > 0.05          # rows whose exp(s) + d_scaling < 0
    assert values
    assert grads == {k: True for k in grads}
    assert {"pool.xyz", "pool.scaling", "pool.rotation",
            "linear.5.weight", "gaussian_scaling.bias"} <= set(grads)


def _delta_before_activation(mp):
    real = DeformMLP.forward

    def fault(self, *args):
        out = real(self, *args)
        return out._replace(scales=out.scales + out.d_scales, d_scales=None)

    mp.setattr(DeformMLP, "forward", fault)


def _skip_dropped(mp):
    mp.setattr(DeformMLP, "skip", lambda self, h, x: torch.cat(
        [torch.zeros_like(x), h], dim=-1))


def _positions_not_detached(mp):
    def embed(self, xyz, t):
        t = t.reshape(-1, 1).expand(xyz.shape[0], 1)
        return torch.cat([deform_mlp.encode(xyz, self.fp.field_multires),
                          deform_mlp.encode(t, self.fp.field_t_multires)],
                         dim=-1)

    mp.setattr(DeformMLP, "embed", embed)


@pytest.mark.parametrize("fault", [_delta_before_activation, _skip_dropped,
                                   _positions_not_detached],
                         ids=["delta_before_activation", "skip_dropped",
                              "positions_not_detached"])
def test_planted_faults_do_not_match(fault, monkeypatch):
    prog, ref = both_fields(PUBLISHED)
    fault(monkeypatch)
    values, grads, _ = attribute_gaps(prog, ref)
    assert not (values and all(grads.values()))


# --------------------------------------------------------------------------
# the preset, and one train step against the plain reference
# --------------------------------------------------------------------------

def test_preset_is_the_benchmark_configuration():
    model, pipe, opt, hp, fp = preset()
    config = bench_config()
    assert model.stride == 10
    assert (hp.no_ds, hp.no_dr, hp.no_do, hp.no_dshs) == (True,) * 4
    assert not (hp.no_dx or hp.feat_head)
    assert (hp.plane_tv_weight, hp.time_smoothness_weight,
            hp.l1_time_planes) == (0.0, 0.0, 0.0)
    assert opt == OptimizationParams() and pipe == PipelineParams()
    assert fp == PUBLISHED
    assert ModelHiddenParams(**config["model"]) == hp
    assert FieldParams(**config["field"]["params"]) == fp
    assert config["reduced"] == []


def tiny_config():
    """The benchmark's configuration at a few thousand rows and 64x96
    views, the network's widths kept."""
    cfg = copy.deepcopy(bench_config())
    cfg.update(num_pts=3000, capacity=4096)
    cfg["clip"].update(frames=12, height=64, width=96)
    cfg["raster"].update(pair_budget=1 << 16, max_visible=4096)
    return cfg


def one_step_gradients(step_forward, step_gradients, state, cam, config,
                       settings):
    hp, opt, pipe, cfg = settings
    loss, _, tree, tap = step_forward(state, cam, "fine",
                                      config["sh_degree"], hp, opt, pipe,
                                      cfg, torch.zeros(3))
    grads, tap_grad = step_gradients(loss, tree, tap)
    flat = {f"{g}.{k}": v for g, d in grads.items() for k, v in d.items()}
    return float(loss.detach()), {**flat, "tap": tap_grad}


def test_step_matches_the_plain_reference():
    from benchmark.frozen import fields, reference
    from benchmark.frozen.ref.train import trainer as ref_trainer
    from benchmark.harness import clip as clipgen
    from benchmark.harness.train import _program_cameras, _program_settings
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train import trainer

    config, dev = tiny_config(), torch.device("cpu")
    clip = clipgen.make_clip(config, SEED, dev)
    view = clip.train_units[5][0]
    settings = _program_settings(config)
    pool = create_from_pcd(clip.points.numpy(), clip.colors.numpy(),
                           config["capacity"], config["sh_degree"],
                           device=dev)
    field = fields.program(config, settings[0], torch.Generator().manual_seed(
        SEED % (1 << 63)), dev)
    assert type(field) is DeformMLP
    state = trainer.init_state(pool, field, clip.aabb)
    loss, grads = one_step_gradients(
        trainer.step_forward, trainer.step_gradients, state,
        _program_cameras(clip, config)[view], config, settings)

    # one start: the port's KNN below 4,097 points is its numpy search,
    # which differs from the native search (the reference's) on a few
    # rows' initial scales
    ref_state, ref_settings = reference.initial_state(clip, config, SEED, dev)
    with torch.no_grad():
        state.pool.scaling.copy_(ref_state.pool.scaling)
    for k, v in ref_state.pool.param_dict().items():
        assert torch.equal(state.pool.param_dict()[k], v), k
    for a, b in zip(state.deform.parameters(),
                    ref_state.deform.parameters()):
        assert torch.equal(a, b)
    ref_cam = reference.camera(clip.views[view], config["clip"],
                               clipgen.fov(config["clip"]))
    ref_loss, ref_grads = one_step_gradients(
        ref_trainer.step_forward, ref_trainer.step_gradients, ref_state,
        ref_cam, config, ref_settings)

    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert set(grads) == set(ref_grads)
    assert {"pool.xyz", "pool.rotation", "pool.scaling",
            "deform.linear.5.weight", "deform.gaussian_rotation.weight",
            "deform.gaussian_scaling.bias"} <= set(grads)
    for k, want in ref_grads.items():
        norm = float(want.norm())
        assert norm > 0, f"{k}: no gradient reaches it"
        gap = float((grads[k] - want).norm())
        assert gap <= STEP_GRAD_RTOL * norm, (k, gap / norm)


# --------------------------------------------------------------------------
# the factory and the repairs beside it
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,cls", [("hexplane", DeformationField),
                                      ("deformable3dgs", DeformMLP)])
def test_the_factory_builds_the_field_a_kind_names(kind, cls):
    hp = ModelHiddenParams(net_width=16, multires=[1], kplanes_config=dict(
        ModelHiddenParams().kplanes_config, resolution=[4, 4, 4, 3]))
    field = build_field(hp, FieldParams(field_kind=kind, field_width=16),
                        torch.Generator().manual_seed(1), "cpu")
    assert type(field) is cls and field.kind == kind
    assert train_cli.make_deformation(hp, FieldParams(field_kind=kind,
                                                      field_width=16), 1,
                                      "cpu").state_dict().keys() \
        == field.state_dict().keys()


def test_the_factory_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="'siren'"):
        build_field(ModelHiddenParams(), FieldParams(field_kind="siren"),
                    torch.Generator(), "cpu")


def small_state(time_smoothness_weight: float):
    """A state of a small d3dgs field over 600 rows, a camera, and the
    step's settings."""
    from s3gaussian_tpu_torch.config import RasterConfig
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train.trainer import init_state

    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(-3, 3, 600), rng.uniform(-1, 1, 600),
                    rng.uniform(2, 8, 600)], 1).astype(np.float32)
    _, _, opt, hp, _ = preset()
    hp.time_smoothness_weight = time_smoothness_weight
    fp = FieldParams(field_kind="deformable3dgs", field_width=32)
    state = init_state(create_from_pcd(pts, rng.random((600, 3)).astype(
        np.float32), 1024, device="cpu"), build_field(
        hp, fp, torch.Generator().manual_seed(2), "cpu"),
        torch.tensor([[9.0] * 3, [-9.0] * 3]))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48, time=0.5,
                      image=rng.random((48, 64, 3)), device="cpu")
    cfg = RasterConfig(max_visible=1024, pair_budget=1 << 16)
    return state, cam, (3, hp, opt, PipelineParams(), cfg, torch.zeros(3))


def test_hexplane_regularisers_only_for_a_field_with_a_grid():
    from s3gaussian_tpu_torch.train.trainer import compute_loss_multicam

    losses = []
    for weight in (0.0, 0.01):
        state, cam, (sh, hp, opt, pipe, cfg, bg) = small_state(weight)
        loss, aux = compute_loss_multicam(
            state.pool, state.deform, torch.zeros(1024, 2), [cam], "fine",
            sh, hp, opt, pipe, state.aabb, bg, cfg)
        assert "reg" not in aux["metrics"]
        losses.append(float(loss))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_the_loss_takes_the_terms_the_field_gives():
    """With the default ModelHiddenParams (the dshs term and the DINO
    head on), as ``--field_kind deformable3dgs`` alone selects it, the
    loss skips the dshs and feature terms: the field gives neither."""
    from s3gaussian_tpu_torch.train.trainer import compute_loss_multicam

    state, cam, (sh, _, opt, pipe, cfg, bg) = small_state(0.0)
    hp = ModelHiddenParams()
    assert not hp.no_dshs and hp.feat_head
    cam = dataclasses.replace(cam, feat_map=torch.rand(48, 64, 3))
    loss, aux = compute_loss_multicam(
        state.pool, state.deform, torch.zeros(1024, 2), [cam], "fine", sh,
        hp, opt, pipe, state.aabb, bg, cfg)
    assert np.isfinite(float(loss))
    assert "dx" in aux["metrics"] and "feat" not in aux["metrics"]


def test_jax_state_tree_refuses_a_d3dgs_field():
    from s3gaussian_tpu_torch.weights import train_state_to_numpy
    state = small_state(0.0)[0]
    with pytest.raises(ValueError, match="deformable3dgs"):
        train_state_to_numpy(state)


# --------------------------------------------------------------------------
# the training CLI on a mini clip
# --------------------------------------------------------------------------

CLI_ARGV = ["--configs", PRESET, "--num_pts", "500", "--pool_capacity",
            "1024", "--coarse_iterations", "4", "--iterations", "6",
            "--densification_interval", "2", "--densify_from_iter", "1",
            "--opacity_reset_interval", "1000", "--checkpoint_iterations",
            "6", "--max_visible", "1024", "--rect_w", "4", "--rect_h", "4",
            "--chunk", "32", "--load_h", "64", "--load_w", "96"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The CLI from the preset through both stages and its final sweep,
    then ``--eval_only`` on its model path and a resume of the fine
    stage: (clip, out, final state, [field of each sweep], the resumed
    state)."""
    from waymo_fixture import make_fixture

    root = tmp_path_factory.mktemp("d3dgs_cli")
    src = make_fixture(str(root / "clip"), n_frames=3)
    out = str(root / "out")
    swept = []
    orig = train_cli.do_evaluation

    def recording(*a, **k):
        swept.append(copy.deepcopy(a[4]))
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S3G_LOG_EVERY", "1")
        mp.setenv("S3G_LPIPS_WEIGHTS", LPIPS_FIXTURE)
        mp.setattr(train_cli, "do_evaluation", recording)
        argv = ["-s", src, "--model_path", out] + CLI_ARGV
        state = train_cli.main(argv, device="cpu")
        train_cli.main(argv + ["--eval_only"], device="cpu")
        resumed = train_cli.main(
            ["-s", src, "--model_path", str(root / "resumed"),
             "--start_checkpoint", os.path.join(out, "chkpnt_fine_6"),
             "--skip_final_eval"] + CLI_ARGV + ["--iterations", "8"],
            device="cpu")
    return src, out, state, swept, resumed


def test_cli_trains_the_field_through_both_stages(cli_run):
    _, out, state, _, _ = cli_run
    assert type(state.deform) is DeformMLP
    with open(os.path.join(out, "logger.json")) as f:
        log = [json.loads(line) for line in f]
    assert {(l["stage"], l["step"]) for l in log if "Loss" in l} >= {
        ("coarse", 4), ("fine", 6)}
    assert all(np.isfinite(l["Loss"]) for l in log if "Loss" in l)
    assert {l["stage"] for l in log if "densify" in l} == {"coarse", "fine"}
    with open(os.path.join(out, "cfg_args")) as f:
        args = ast.literal_eval(f.read())
    assert {k: args[k] for k in dataclasses.asdict(PUBLISHED)} == \
        dataclasses.asdict(PUBLISHED)
    flat = torch.load(os.path.join(out, "chkpnt_fine_6", "state.pt"),
                      weights_only=True)
    assert flat["deform.linear.5.weight"].shape == (256, 340)
    for k, v in state.deform.state_dict().items():
        assert torch.equal(flat[f"deform.{k}"], v), k


def test_the_sweep_and_eval_only_take_the_trained_field(cli_run):
    _, out, state, swept, _ = cli_run
    assert len(swept) == 2            # the final sweep, then --eval_only's
    want = state.deform.state_dict()
    for field in swept:
        assert type(field) is DeformMLP
        got = field.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    metrics = os.listdir(os.path.join(out, "eval", "metrics"))
    assert any(name.startswith(f"{int(state.step)}_") for name in metrics)


def test_the_tools_rebuild_the_field_from_cfg_args(cli_run):
    from s3gaussian_tpu_torch.tools.trained import load_trained, read_cfg_args
    _, out, state, _, _ = cli_run
    run = read_cfg_args(out)
    assert run.field == PUBLISHED
    got = load_trained(run, out, device="cpu").state.deform
    assert type(got) is DeformMLP
    for k, v in state.deform.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_start_checkpoint_resumes_the_field(cli_run):
    _, _, state, _, resumed = cli_run
    assert type(resumed.deform) is DeformMLP
    assert int(resumed.step) == int(state.step) + 2
    assert not torch.equal(resumed.deform.linear[0].weight,
                           state.deform.linear[0].weight)


def test_exchange_export_refuses_the_field(cli_run, tmp_path):
    from s3gaussian_tpu_torch.tools import exchange
    _, out, _, _, _ = cli_run
    with pytest.raises(ValueError, match="deformable3dgs"):
        exchange.export_run(out, str(tmp_path / "run.npz"), device="cpu")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step is captured as a CUDA "
                    "graph and runs the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replays_equal_eager_steps_bit_for_bit(cuda_device):
    """A block of 4 replays of the captured step of this field at its
    published widths against 4 eager steps from one state: every tensor
    of the state (parameters, moments, statistics, counters) and every
    step's loss equal."""
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors

    from test_torch_cuda import _graph_cameras, _graph_setup

    small, args = _graph_setup(cuda_device, seed=16)
    hp = preset()[3]
    state = tr.init_state(small.pool, build_field(
        hp, PUBLISHED, torch.Generator().manual_seed(1), cuda_device),
        small.aabb)
    args = (args[0], hp) + args[2:]
    cams = _graph_cameras(cuda_device, 4, seed=26)
    eager = graphs.clone_state(state)
    losses = []
    for c in cams:
        eager, aux = tr.train_step(eager, c, "fine", *args)
        losses.append(aux["metrics"]["loss"])
    graphs.release()
    try:
        got, gaux = tr.train_steps_scan(state, cams, "fine", *args)
        torch.cuda.synchronize()
        assert graphs.current().replays == 4
    finally:
        graphs.release()
    assert torch.equal(gaux["metrics"]["loss"], torch.stack(losses))
    a, b = state_tensors(got), state_tensors(eager)
    assert [k for k in b if not torch.equal(a[k], b[k])] == []
