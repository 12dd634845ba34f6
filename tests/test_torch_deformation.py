"""Port parity: grid sampling, the hexplane and the deformation field.

Tolerances: float32 sampling and the hexplane at atol 1e-5; the
bfloat16-plane hexplane (``grid_compute_bf16``) at atol 2e-2, because the
two frameworks round the bfloat16 time-row lerp at different places; the
deformation field, with JAX-initialised weights carried across by
``weights.deformation_from_numpy``, at atol 1e-5 in float32 and 2e-2 with
bfloat16 planes."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams
from s3gaussian_tpu.models import deformation as jdef
from s3gaussian_tpu.models import hexplane as jhx
from s3gaussian_tpu.ops import gridsample as jgs
from s3gaussian_tpu_torch.models import deformation as tdef
from s3gaussian_tpu_torch.models import hexplane as thx
from s3gaussian_tpu_torch.ops import gridsample as tgs
from s3gaussian_tpu_torch.weights import deformation_from_numpy

import tiny_config
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(tiny_config.ModelHiddenParams,
            kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                            "output_coordinate_dim": 4,
                            "resolution": [8, 8, 8, 5]})
AABB = np.array([[2.0, 2.0, 2.0], [-2.0, -2.0, -1.0]], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def test_grid_sample_2d_3d_match_jax():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(5, 9, 13)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (257, 2)).astype(np.float32)   # incl. oob
    np.testing.assert_allclose(
        tgs.grid_sample_2d(t(grid), t(coords)).numpy(),
        np.asarray(jgs.grid_sample_2d(jnp.asarray(grid), jnp.asarray(coords))),
        atol=1e-5)
    grid3 = rng.normal(size=(3, 5, 7, 6)).astype(np.float32)
    coords3 = rng.uniform(-1.3, 1.3, (129, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.grid_sample_3d(t(grid3), t(coords3)).numpy(),
        np.asarray(jgs.grid_sample_3d(jnp.asarray(grid3),
                                      jnp.asarray(coords3))),
        atol=1e-5)


@pytest.mark.parametrize("rows,tval", [(7, 0.3), (7, 1.0), (7, -1.2), (1, 0.5)])
def test_sample_time_plane_matches_jax(rows, tval):
    rng = np.random.default_rng(rows)
    plane = rng.normal(size=(4, rows, 11)).astype(np.float32)
    sx = rng.uniform(-1.2, 1.2, 100).astype(np.float32)
    want = jgs.sample_time_plane(jnp.asarray(plane), jnp.asarray(sx),
                                 jnp.asarray(tval, jnp.float32))
    got = tgs.sample_time_plane(t(plane), t(sx),
                                torch.tensor(tval, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("bf16,scalar_t", [(False, True), (False, False),
                                           (True, True)])
def test_query_hexplane_matches_jax(bf16, scalar_t):
    params = jhx.init_hexplane(jax.random.PRNGKey(1), 4, (8, 8, 8, 5), (1, 2))
    # non-constant time planes so the time lerp matters
    params = {k: v * (1.0 + 0.3 * jax.random.normal(jax.random.PRNGKey(i),
                                                    v.shape))
              for i, (k, v) in enumerate(sorted(params.items()))}
    tparams = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(t(v)) for k, v in params.items()})
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.2, 2.2, (150, 3)).astype(np.float32)
    tv = (np.float32(0.37) if scalar_t
          else rng.random((150, 1)).astype(np.float32))
    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = jhx.query_hexplane(params, jnp.asarray(pts), jnp.asarray(tv),
                              jnp.asarray(AABB), 2, compute_dtype=dtype[0])
    got = thx.query_hexplane(tparams, t(pts), t(tv), t(AABB), 2,
                             compute_dtype=dtype[1])
    assert got.dtype == torch.float32 and got.shape == (150, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-2 if bf16 else 1e-5)


def test_init_matches_jax_shapes_and_is_seeded():
    hp = ModelHiddenParams(**TINY)
    tree = jdef.init_deformation(jax.random.PRNGKey(0), hp)
    a = tdef.DeformationField(hp, torch.Generator().manual_seed(3), "cpu")
    b = tdef.DeformationField(hp, torch.Generator().manual_seed(3), "cpu")
    for k, v in tree["grid"].items():
        pa = a.grid[k].detach()
        assert tuple(pa.shape) == v.shape
        torch.testing.assert_close(pa, b.grid[k].detach(), rtol=0, atol=0)
        if k.endswith(("plane2", "plane4", "plane5")):     # time planes
            assert bool((pa == 1).all())
        else:
            assert 0.1 <= float(pa.min()) <= float(pa.max()) <= 0.5
    lin = a.feature_out[0]
    assert tuple(lin.weight.T.shape) == tree["mlp"]["feature_out"][0]["w"].shape
    bound = (6.0 / sum(lin.weight.shape)) ** 0.5
    assert float(lin.weight.detach().abs().max()) <= bound


VARIANTS = {
    "default": {},
    "bf16": {"grid_compute_bf16": True},
    "static_mlp": {"static_mlp": True},
    "empty_voxel": {"empty_voxel": True},
    "all_heads": {"no_ds": False, "no_dr": False, "no_do": False},
    "rotation": {"no_dr": False, "apply_rotation": True, "feat_head": False},
    # 4DGaussians' N3V decoder (arguments/waymo_4dgs.py) at its widths on a
    # small spatial grid: feature_out one Linear(32, 128), five heads, no
    # DINO head
    "n3v_decoder": {"defor_depth": 0, "net_width": 128, "multires": [1, 2],
                    "kplanes_config": {"grid_dimensions": 2,
                                       "input_coordinate_dim": 4,
                                       "output_coordinate_dim": 16,
                                       "resolution": [8, 8, 8, 150]},
                    "no_ds": False, "no_dr": False, "no_do": False,
                    "feat_head": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_deformation_matches_jax(variant):
    hp = ModelHiddenParams(**{**TINY, "grid_compute_bf16": False,
                              **VARIANTS[variant]})
    tree = jdef.init_deformation(jax.random.PRNGKey(5), hp)
    if hp.empty_voxel:
        tree["empty_voxel"] = jax.random.uniform(jax.random.PRNGKey(6),
                                                 (1, 64, 64, 64))
    field = deformation_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   hp, device="cpu")
    rng = np.random.default_rng(7)
    n = 200
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    scales = rng.normal(-3, 0.5, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.normal(size=(n, 1)).astype(np.float32)
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32)
    tval = np.float32(0.41)
    want = jdef.apply_deformation(tree, hp, jnp.asarray(AABB),
                                  *[jnp.asarray(a) for a in
                                    (xyz, scales, rot, opac, shs, tval)])
    with torch.no_grad():
        got = field(*[t(a) for a in (xyz, scales, rot, opac, shs, tval)],
                    aabb=t(AABB))
    atol = 2e-2 if hp.grid_compute_bf16 else 1e-5
    # the port's activated-space deltas, which the JAX field has not,
    # are None for the hexplane field
    for name in tdef.DeformOut._fields:
        w, g = getattr(want, name, None), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                       err_msg=name)


def test_deformation_from_numpy_rejects_mismatch():
    hp = ModelHiddenParams(**dict(TINY, grid_compute_bf16=False))
    tree = jax.tree_util.tree_map(
        np.asarray, jdef.init_deformation(jax.random.PRNGKey(0), hp))
    other = ModelHiddenParams(**dict(TINY, grid_compute_bf16=False,
                                     static_mlp=True))
    with pytest.raises(ValueError, match="heads"):
        deformation_from_numpy(tree, other, device="cpu")
    wide = dataclasses.replace(hp, net_width=32)
    with pytest.raises(ValueError, match="shape"):
        deformation_from_numpy(tree, wide, device="cpu")
