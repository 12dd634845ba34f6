"""The port's scene-flow pieces against the JAX package's:
``scene_flow_to_rgb`` (and the HSV conversion written in the port in
place of matplotlib's) within 1e-6, ``gt_flow_from_boxes``/``flow_epe``
on shared arrays and ``deformation_flow_epe`` on one field carried
across (rtol 1e-5)."""

import json

import jax
import matplotlib.colors as mcolors
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams
from s3gaussian_tpu.eval import flow as jf
from s3gaussian_tpu.eval.visualization import scene_flow_to_rgb as j_flow_rgb
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu.models.pool import create_from_pcd
from s3gaussian_tpu_torch.eval import flow as tf
from s3gaussian_tpu_torch.eval.visualization import (hsv_to_rgb,
                                                     scene_flow_to_rgb)
from s3gaussian_tpu_torch.weights import deformation_from_numpy, pool_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

BOXES = [
    {"center0": [10.0, 0.0, 1.0], "vel": [2.0, 0.0, 0.0],
     "half": [1.0, 1.0, 1.0]},
    {"center0": [0.0, 5.0, 1.0], "vel": [0.0, -1.0, 0.0],
     "half": [1.0, 1.0, 1.0]},
]


def flows(seed, n=4096):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    f[:16] = 0.0                                  # no motion: black
    f[16:24, 1] = 0.0                             # on the hue wrap (h = 0)
    f[24:32, 0] = 0.0
    f[32:40] *= 100.0                             # clipped magnitudes
    return f


@pytest.mark.parametrize("background", ["dark", "light"])
@pytest.mark.parametrize("radius", [2.0, 0.5])
def test_scene_flow_to_rgb_matches_jax(background, radius):
    f = flows(0)
    want = j_flow_rgb(f, flow_max_radius=radius, background=background)
    got = scene_flow_to_rgb(torch.from_numpy(f), flow_max_radius=radius,
                            background=background)
    assert got.dtype == torch.float32 and got.shape == f.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_hsv_to_rgb_matches_matplotlib():
    rng = np.random.default_rng(1)
    hsv = rng.random((20000, 3)).astype(np.float32)
    hsv[:8, 0] = 1.0                              # sector 6 wraps to 0
    hsv[8:16, 1] = 0.0                            # grey
    hsv[16:23, 0] = np.arange(7) / 6.0            # sector edges
    np.testing.assert_allclose(hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               mcolors.hsv_to_rgb(hsv), rtol=0, atol=1e-6)


def test_gt_flow_and_flow_epe_match_jax():
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.uniform(-0.9, 0.9, (100, 3)) + c for c in
                          ([10.0, 0, 1], [0, 5.0, 1], [30.0, 0, 0])])
    dx_t = rng.normal(0, 0.1, xyz.shape).astype(np.float32)
    dx_t2 = dx_t + rng.normal(0, 1.0, xyz.shape).astype(np.float32)
    alive = rng.random(len(xyz)) > 0.1
    for t, dt in ((0.0, 1.0), (1.5, 3.0)):
        np.testing.assert_array_equal(
            tf.gt_flow_from_boxes(xyz, BOXES, t, dt),
            jf.gt_flow_from_boxes(xyz, BOXES, t, dt))
        want = jf.flow_epe(xyz, dx_t, dx_t2, BOXES, t, dt, alive=alive)
        got = tf.flow_epe(xyz, dx_t, dx_t2, BOXES, t, dt, alive=alive)
        assert got == want


def test_load_gt_motion(tmp_path):
    assert tf.load_gt_motion(str(tmp_path)) is None
    (tmp_path / "gt_motion.json").write_text(json.dumps({"boxes": BOXES}))
    assert tf.load_gt_motion(str(tmp_path)) == jf.load_gt_motion(
        str(tmp_path))


def test_deformation_flow_epe_matches_jax():
    rng = np.random.default_rng(0)
    stat = rng.uniform([-20, -20, 0], [20, 20, 5], (300, 3))
    car1 = rng.uniform(-0.8, 0.8, (100, 3)) + [10.0, 0.0, 1.0]
    car2 = rng.uniform(-0.8, 0.8, (100, 3)) + [0.0, 5.0, 1.0]
    pts = np.concatenate([stat, car1, car2]).astype(np.float32)
    jpool = create_from_pcd(pts, np.full((500, 3), 0.5, np.float32), 512)
    hp = ModelHiddenParams(
        net_width=16, grid_compute_bf16=False, multires=[1, 2],
        kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                        "output_coordinate_dim": 8,
                        "resolution": [8, 8, 8, 4]})
    # planes perturbed off their initial values, so the field moves with
    # time and the learned flow is not zero
    noise = np.random.default_rng(1)
    field = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (1 + 0.5 * noise.normal(
            size=np.shape(x))).astype(np.float32),
        init_deformation(jax.random.PRNGKey(0), hp))
    aabb = np.array([[25.0, 25.0, 8.0], [-25.0, -25.0, -2.0]], np.float32)
    gt = {"boxes": BOXES}
    want = jf.deformation_flow_epe(jpool, field, hp, aabb, gt, n_frames=8)
    got = tf.deformation_flow_epe(
        pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, jpool)),
                        device="cpu"),
        deformation_from_numpy(field, hp, device="cpu"),
        torch.from_numpy(aabb), gt, n_frames=8)
    assert got.keys() == want.keys() == {"t0_off1", "t0_off3", "t4_off1",
                                         "t4_off3"}
    for key in want:
        assert got[key].keys() == want[key].keys()
        for k, v in want[key].items():
            if isinstance(v, int) or v is None:
                assert got[key][k] == v, (key, k)
            else:
                np.testing.assert_allclose(got[key][k], v, rtol=1e-5,
                                           err_msg=f"{key} {k}")
    assert any(r["epe_static"] > 1e-3 for r in got.values())
