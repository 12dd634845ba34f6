"""The port's own config dataclasses keep the JAX package's field names
and defaults (only the TPU-only fields are left out); its native KNN
loader; its entry points put tensors on the card unless asked for the
CPU."""

import dataclasses
import inspect

import numpy as np
import pytest

from s3gaussian_tpu import config as jcfg
from s3gaussian_tpu_torch import config as tcfg
from s3gaussian_tpu_torch.ops import knn as tknn

DROPPED = {
    "ModelHiddenParams": {"remat_deform"},
    "RasterConfig": {"max_pairs_per_tile", "use_pallas", "sort_bf16",
                     "sort_hier", "multicam_serialize", "multicam_scan"},
    "PipelineParams": set(),
    "OptimizationParams": set(),
}


def _defaults(cls):
    return {f.name: (f.default_factory() if f.default is dataclasses.MISSING
                     else f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", sorted(DROPPED))
def test_port_config_fields_keep_jax_defaults(name):
    port, ref = _defaults(getattr(tcfg, name)), _defaults(getattr(jcfg, name))
    assert set(ref) - set(port) == DROPPED[name]
    assert set(port) <= set(ref)
    for k, v in port.items():
        assert v == ref[k], (name, k, v, ref[k])
    if name == "RasterConfig":
        p, r = tcfg.RasterConfig(big_budget=3), jcfg.RasterConfig(big_budget=3)
        assert (p.rect_cap, p.max_pairs, p.n_pair_slots(40)) == \
            (r.rect_cap, r.max_pairs, r.n_pair_slots(40))


def test_knn_native_loader_matches_numpy_search():
    """Above 4,096 points the port calls the native library through its
    own loader; it agrees with the port's numpy Morton-window search."""
    pts = np.random.default_rng(0).uniform(-5, 5, (5000, 3)).astype(
        np.float32)
    native = tknn._native_knn(pts, 3, 32)
    if native is None:
        pytest.skip("native/libs3g_native.so could not be built here")
    want = tknn.mean_knn_dist2(pts[:4000])     # numpy path
    got = tknn._native_knn(pts[:4000], 3, 32)
    # both are Morton-window searches; equal codes may sort in another
    # order and shift a few windows (the criterion of tests/test_native.py)
    rel = np.abs(got - want) / np.maximum(want, 1e-9)
    assert (rel < 1e-5).mean() > 0.99
    assert np.median(rel) < 1e-7
    np.testing.assert_array_equal(tknn.mean_knn_dist2(pts), native)


def _entry_points():
    from s3gaussian_tpu_torch import weights
    from s3gaussian_tpu_torch.data import cameras
    from s3gaussian_tpu_torch.models import deformation, hexplane, pool
    return {"create_from_pcd": pool.create_from_pcd,
            "PoolStats.zeros": pool.PoolStats.zeros,
            "DeformationField": deformation.DeformationField.__init__,
            "init_hexplane": hexplane.init_hexplane,
            "make_camera": cameras.make_camera,
            "pool_from_numpy": weights.pool_from_numpy,
            "deformation_from_numpy": weights.deformation_from_numpy,
            "train_state_from_numpy": weights.train_state_from_numpy}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
