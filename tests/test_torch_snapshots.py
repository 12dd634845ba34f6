"""The port's training snapshots against the JAX package's: the turbo
colormap against matplotlib's, ``visualize_depth`` against the JAX
function, and ``render_training_image``'s GT | render | depth strip
against the one the JAX package writes for the same pool and camera."""

import numpy as np
import pytest
from PIL import Image

from s3gaussian_tpu.eval import snapshots as jsnap
from s3gaussian_tpu.eval import visualization as jvis
from s3gaussian_tpu_torch.eval import snapshots as tsnap
from s3gaussian_tpu_torch.eval import visualization as tvis
from torch_threads import one_torch_thread  # noqa: F401


def test_turbo_matches_matplotlib():
    from matplotlib import colormaps
    t = np.concatenate([np.linspace(0, 1, 10_001), np.arange(257) / 256,
                        [-0.5, -1e-9, 1 + 1e-9, 2.0, np.nan]])
    np.testing.assert_array_equal(tvis.turbo(t),
                                  colormaps["turbo"](t)[..., :3])


def test_visualize_depth_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 90.0, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.2] = 0.0              # no depth there
    np.testing.assert_array_equal(tvis.visualize_depth(depth),
                                  jvis.visualize_depth(depth))
    empty = np.zeros((8, 8), np.float32)
    np.testing.assert_array_equal(tvis.visualize_depth(empty),
                                  jvis.visualize_depth(empty))
    np.testing.assert_array_equal(tvis.to8b(depth / 90), jvis.to8b(depth / 90))


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_training_snapshot_matches_jax(tmp_path, stage):
    """The GT third is identical; the render third within one 8-bit level
    (renders agree to 5e-4); the depth third within a few colormap steps
    at 99% of the pixels (its percentiles follow the depths' last bits).
    The label is drawn by PIL in both."""
    import jax
    import jax.numpy as jnp
    import torch

    from s3gaussian_tpu.config import ModelHiddenParams as JHP
    from s3gaussian_tpu.config import PipelineParams as JPipe
    from s3gaussian_tpu.config import RasterConfig as JRC
    from s3gaussian_tpu.data.cameras import make_camera as jmake_camera
    from s3gaussian_tpu.models.deformation import init_deformation
    from s3gaussian_tpu.models.pool import create_from_pcd
    from s3gaussian_tpu_torch import config as tcfg
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.weights import (deformation_from_numpy,
                                              pool_from_numpy)

    import tiny_config

    rng = np.random.default_rng(1)
    n, h, w = 600, 48, 64
    z = rng.uniform(2.0, 12.0, n)
    pts = np.stack([rng.uniform(-0.4, 0.4, n) * z,
                    rng.uniform(-0.3, 0.3, n) * z, z], 1).astype(np.float32)
    pool = create_from_pcd(pts, rng.random((n, 3)).astype(np.float32), 1024)
    hp_kw = dict(tiny_config.ModelHiddenParams, grid_compute_bf16=False)
    deform = init_deformation(jax.random.PRNGKey(0), JHP(**hp_kw))
    image = rng.random((h, w, 3)).astype(np.float32)
    cam_kw = dict(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8, width=w,
                  height=h, time=0.3, image=image)
    aabb = np.array([[15.0] * 3, [-15.0] * 3], np.float32)
    cfg_kw = dict(max_visible=1024, pair_budget=1 << 15)

    jpath = jsnap.render_training_image(
        str(tmp_path / "j"), stage + "train", 999, jmake_camera(**cam_kw),
        pool, deform, JHP(**hp_kw), JPipe(), jnp.zeros(3), jnp.asarray(aabb),
        3, stage, JRC(**cfg_kw, max_pairs_per_tile=1 << 12), elapsed=3.0)
    tpath = tsnap.render_training_image(
        str(tmp_path / "t"), stage + "train", 999,
        make_camera(**cam_kw, device="cpu"),
        pool_from_numpy(vars(jax.tree_util.tree_map(np.asarray, pool)),
                        device="cpu"),
        deformation_from_numpy(jax.tree_util.tree_map(np.asarray, deform),
                               tcfg.ModelHiddenParams(**hp_kw), "cpu"),
        tcfg.PipelineParams(), torch.zeros(3), torch.tensor(aabb), 3, stage,
        tcfg.RasterConfig(**cfg_kw), elapsed=3.0)
    assert tpath.endswith("train_render/" + stage + "train_00999.png")
    want = np.asarray(Image.open(jpath)).astype(int)
    got = np.asarray(Image.open(tpath)).astype(int)
    assert got.shape == want.shape == (h, 3 * w, 3)
    np.testing.assert_array_equal(got[:, :w], want[:, :w])
    assert np.abs(got[:, w:2 * w] - want[:, w:2 * w]).max() <= 1
    assert (got[:, w:2 * w] > 0).mean() > 0.2        # the render is not empty
    depth = np.abs(got[:, 2 * w:] - want[:, 2 * w:]).max(-1)
    assert np.quantile(depth, 0.99) <= 3
