"""Port parity: camera math, SH, covariance, projection and SH colours of
``s3gaussian_tpu_torch`` vs the JAX package on the same numpy inputs.

Float outputs agree to atol 1e-5 (rtol 1e-6 for pixel coordinates, which
reach ~1e2 where one float32 ulp is ~8e-6); integer outputs (tile rects,
radii) and the visibility mask are exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.ops import project as jproject
from s3gaussian_tpu.ops import sh as jsh
from s3gaussian_tpu.ops import transforms as jtf
from s3gaussian_tpu_torch.ops import project as tproject
from s3gaussian_tpu_torch.ops import sh as tsh
from s3gaussian_tpu_torch.ops import transforms as ttf

from scenes import random_scene
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(37, 4)).astype(np.float32)
    q2 = rng.normal(size=(37, 4)).astype(np.float32)
    close(ttf.quat_to_rotmat(t(q1)), jtf.quat_to_rotmat(jnp.asarray(q1)))
    close(ttf.quat_multiply(t(q1), t(q2)),
          jtf.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
    R = np.asarray(jtf.quat_to_rotmat(jnp.asarray(q1[:1])))[0]
    T = rng.normal(size=3)
    np.testing.assert_array_equal(ttf.world_to_view(R, T),
                                  jtf.world_to_view(R, T))
    P = ttf.projection_matrix(0.01, 100.0, 1.1, 0.8)
    np.testing.assert_array_equal(P, jtf.projection_matrix(0.01, 100.0, 1.1,
                                                           0.8))
    w2c = ttf.world_to_view(R, T)
    np.testing.assert_array_equal(ttf.full_projection(w2c, P),
                                  jtf.full_projection(w2c, P))
    np.testing.assert_array_equal(ttf.camera_center(w2c),
                                  jtf.camera_center(w2c))
    assert ttf.fov2focal(1.1, 640) == jtf.fov2focal(1.1, 640)
    assert ttf.focal2fov(500.0, 640) == jtf.focal2fov(500.0, 640)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(53, 3, 16)).astype(np.float32)
    d = rng.normal(size=(53, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    close(tsh.eval_sh(deg, t(sh), t(d)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    rgb = rng.random((5, 3)).astype(np.float32)
    close(tsh.RGB2SH(t(rgb)), jsh.RGB2SH(jnp.asarray(rgb)))
    close(tsh.SH2RGB(t(sh)), jsh.SH2RGB(jnp.asarray(sh)))


def test_build_cov3d_matches_jax():
    sc = random_scene(n=200, seed=3)
    got = tproject.build_cov3d(t(sc["scales"]), t(sc["quats"]), 1.3)
    want = jproject.build_cov3d(jnp.asarray(sc["scales"]),
                                jnp.asarray(sc["quats"]), 1.3)
    close(got, want)


def _project_both(sc, w, h, tight, alive=None, margin=0.0):
    cov_j = jproject.build_cov3d(jnp.asarray(sc["scales"]),
                                 jnp.asarray(sc["quats"]))
    cov_t = tproject.build_cov3d(t(sc["scales"]), t(sc["quats"]))
    want = jproject.project_gaussians(
        jnp.asarray(sc["means"]), cov_j, jnp.asarray(sc["view"]),
        jnp.asarray(sc["proj"]), sc["tanfov"], sc["tanfov"], w, h, 16, 16,
        alive=None if alive is None else jnp.asarray(alive),
        radius_margin=margin,
        opacities=jnp.asarray(sc["opacity"]) if tight else None)
    got = tproject.project_gaussians(
        t(sc["means"]), cov_t, t(sc["view"]), t(sc["proj"]), sc["tanfov"],
        sc["tanfov"], w, h, 16, 16,
        alive=None if alive is None else t(alive), radius_margin=margin,
        opacities=t(sc["opacity"]) if tight else None)
    return got, want


@pytest.mark.parametrize("tight,seed,w,h,margin", [
    (True, 0, 64, 48, 0.0),
    (False, 1, 96, 64, 0.0),
    (True, 2, 80, 80, 8.0),
])
def test_project_gaussians_matches_jax(tight, seed, w, h, margin):
    # zrange reaching behind the near plane exercises the cull and tz clamp
    sc = random_scene(n=300, seed=seed, w=w, h=h, zrange=(-1.0, 9.0),
                      scale_range=(0.02, 0.5))
    alive = np.random.default_rng(seed).random(300) > 0.1
    got, want = _project_both(sc, w, h, tight, alive, margin)
    close(got.xy, want.xy)
    close(got.depth, want.depth)
    close(got.conic, want.conic)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(want.radius))
    np.testing.assert_array_equal(got.tiles_rect.numpy(),
                                  np.asarray(want.tiles_rect))
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(want.visible))
    assert got.visible.any() and not got.visible.all()


@pytest.mark.parametrize("deg", [0, 3])
def test_sh_to_color_matches_jax(deg):
    rng = np.random.default_rng(deg + 10)
    shs = rng.normal(size=(120, 16, 3)).astype(np.float32) * 0.5
    means = rng.normal(size=(120, 3)).astype(np.float32)
    campos = np.array([0.1, -0.2, 0.3], np.float32)
    means[0] = campos                    # dead slot at the camera origin
    got = tproject.sh_to_color(t(shs), t(means), t(campos), deg)
    want = jproject.sh_to_color(jnp.asarray(shs), jnp.asarray(means),
                                jnp.asarray(campos), deg)
    close(got, want)
    assert torch.isfinite(got).all()
