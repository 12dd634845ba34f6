"""4DGaussians' full-attribute decoder (``arguments/waymo_4dgs.py``: its
N3V preset's ``ModelHiddenParams``, five heads at width 128 after one
Linear(32, 128), a 16-channel hexplane at two scales over 150 time rows,
no DINO head) through the port's train step.

On the CPU: the preset merged into the port's config, and equal to the
``"model"`` of ``benchmark/configs/waymo_4dgs.json``; one eager fine
step of the port against the benchmark's plain reference
(``benchmark/frozen/reference.py`` over ``benchmark/frozen/ref``) from
the same seeded state and view, at the decoder's widths over a few
thousand rows and a small spatial grid: the loss, and the gradient of
every leaf (``pool.rotation``, ``scaling`` and ``opacity`` among them,
which the heads' ds, dr and do reach).  On the card (``cuda``, skipped
without one): a block of replays of the captured step against as many
eager steps, bit for bit (no atomics in the step).

The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_4dgs.py
"""

import copy
import json
import os

import pytest
import torch

from s3gaussian_tpu_torch.config import (ModelHiddenParams, ModelParams,
                                         OptimizationParams, PipelineParams,
                                         apply_config_file)

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(REPO, "arguments", "waymo_4dgs.py")
SEED = 2 ** 31 + 4477          # larger than 32 signed bits hold
# float32 on the CPU on both sides: the same operations, which may sum in
# another order (a few float32 ulps of the loss; of a gradient, a part in
# 1e5 of its leaf's largest entry)
LOSS_RTOL = 1e-6
GRAD_ATOL_SCALE, GRAD_RTOL = 1e-5, 1e-4


def bench_config():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "waymo_4dgs.json")) as f:
        return json.load(f)


def test_preset_merges_the_decoder():
    model, pipe, opt, hp = (ModelParams(), PipelineParams(),
                            OptimizationParams(), ModelHiddenParams())
    apply_config_file(PRESET, model, pipe, opt, hp)
    assert model.stride == 10
    assert hp.kplanes_config == {"grid_dimensions": 2,
                                 "input_coordinate_dim": 4,
                                 "output_coordinate_dim": 16,
                                 "resolution": [64, 64, 64, 150]}
    assert (hp.multires, hp.defor_depth, hp.net_width) == ([1, 2], 0, 128)
    assert not (hp.no_dx or hp.no_ds or hp.no_dr or hp.no_do or hp.no_dshs)
    assert not (hp.apply_rotation or hp.feat_head or hp.static_mlp
                or hp.empty_voxel)
    assert (hp.plane_tv_weight, hp.time_smoothness_weight,
            hp.l1_time_planes) == (0.0002, 0.001, 0.0001)
    # what the preset leaves alone stays the port's default
    assert opt == OptimizationParams() and pipe == PipelineParams()
    assert hp.grid_compute_bf16
    # the benchmark's configuration runs the same decoder
    assert ModelHiddenParams(**bench_config()["model"]) == hp


def tiny_config():
    """The benchmark's configuration at a few thousand rows, 64x96 views
    and a small spatial grid; the decoder's widths and the 150 time rows
    kept."""
    cfg = copy.deepcopy(bench_config())
    cfg.update(num_pts=3000, capacity=4096)
    cfg["clip"].update(frames=12, height=64, width=96)
    cfg["model"]["kplanes_config"]["resolution"] = [8, 8, 8, 150]
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
    from benchmark.frozen import reference
    from benchmark.harness import clip as clipgen
    from benchmark.harness.train import _program_cameras, _program_settings
    from benchmark.frozen.ref.train import trainer as ref_trainer
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train import trainer

    config, dev = tiny_config(), torch.device("cpu")
    clip = clipgen.make_clip(config, SEED, dev)
    view = clip.train_units[5][0]
    settings = _program_settings(config)
    pool = create_from_pcd(clip.points.numpy(), clip.colors.numpy(),
                           config["capacity"], config["sh_degree"],
                           device=dev)
    field = DeformationField(settings[0], torch.Generator().manual_seed(
        SEED % (1 << 63)), dev)
    assert len(field.feature_out) == 1 and field.dino is None
    assert set(field.heads) == {"pos", "scales", "rotations", "opacity",
                                "shs"}
    state = trainer.init_state(pool, field, clip.aabb)
    loss, grads = one_step_gradients(
        trainer.step_forward, trainer.step_gradients, state,
        _program_cameras(clip, config)[view], config, settings)

    # one start: the port's KNN below 4,097 points is its numpy search,
    # which differs from the native search (the reference's, and the
    # port's at the cell's 1.5 M points) on a few rows' initial scales
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
    assert {"pool.rotation", "pool.scaling", "pool.opacity",
            "deform.heads.rotations.3.weight"} <= set(grads)
    for k, want in ref_grads.items():
        got = grads[k]
        scale = float(want.abs().max())
        assert scale > 0, f"{k}: no gradient reaches it"
        err = float((got - want).abs().max())
        assert bool(((got - want).abs() <= GRAD_ATOL_SCALE * scale
                     + GRAD_RTOL * want.abs()).all()), (k, err, scale)


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
    """A block of 4 replays of the captured step of this decoder against
    4 eager steps from one state: every tensor of the state (parameters,
    moments, statistics, counters) and every step's loss equal."""
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.train import graphs
    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors

    from test_torch_cuda import _graph_cameras, _graph_setup

    small, args = _graph_setup(cuda_device, seed=16)
    hp = ModelHiddenParams()
    apply_config_file(PRESET, ModelParams(), PipelineParams(),
                      OptimizationParams(), hp)
    hp.kplanes_config = dict(hp.kplanes_config, resolution=[8, 8, 8, 150])
    state = tr.init_state(small.pool, DeformationField(
        hp, torch.Generator().manual_seed(1), cuda_device), small.aabb)
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
