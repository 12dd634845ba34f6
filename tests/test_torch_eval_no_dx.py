"""The evaluation sweep on a field without the position head
(``no_dx=True``, ``arguments/static_nvs.py``'s field): both packages'
``render_pixels`` on a split laid out as rigs and on one that is not,
from one state carried across (as ``tests/test_torch_eval.py`` does).
The frames and metrics must agree at that file's tolerances, and with no
dx neither package renders flow frames or writes the dynamic/static PLY
split, though the split asks for it and has more cameras than a rig.
"""

import os

import jax
import numpy as np
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams, PipelineParams
from s3gaussian_tpu.eval import lpips_jax
from s3gaussian_tpu.eval import video as j_video
from s3gaussian_tpu.models.deformation import init_deformation
from s3gaussian_tpu_torch.eval import video as t_video
from s3gaussian_tpu_torch.weights import deformation_from_numpy

import test_torch_eval as te
from torch_threads import one_torch_thread  # noqa: F401

FRAME_KEYS = ("rgbs", "gt_rgbs", "depths", "dynamic_rgbs", "static_rgbs")


@pytest.fixture(scope="module")
def no_dx_sweep(tmp_path_factory):
    jpool, _, _, tpool, _ = te._scene()
    hp = ModelHiddenParams(**te.HP, no_dx=True)
    jdeform = init_deformation(jax.random.PRNGKey(0), hp)
    tdeform = deformation_from_numpy(
        jax.tree_util.tree_map(np.asarray, jdeform), hp, device="cpu")
    assert "pos" not in tdeform.heads
    rng = np.random.default_rng(2)
    grouped = te._split(te.RIG_TIMES[:2], tpool, tdeform, rng)
    loose = te._split(te.LOOSE_TIMES, tpool, tdeform, rng)
    loose = (loose[0][::3], loose[1][::3])        # one yaw per time
    pipe = PipelineParams()
    jargs = (jpool, jdeform, hp, pipe, jax.numpy.asarray(te.BG),
             jax.numpy.asarray(te.AABB), 3, "fine", te.J_CFG)
    targs = (tpool, tdeform, pipe, torch.from_numpy(te.BG),
             torch.from_numpy(te.AABB), 3, "fine", te.T_CFG)
    root = tmp_path_factory.mktemp("no_dx")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("S3G_LPIPS_WEIGHTS", raising=False)
        lpips_jax._load_weights.cache_clear()
        j_video._jit_render.cache_clear()
        j_video._jit_render_mc.cache_clear()
        for name, (jc, tc) in (("grouped", grouped), ("loose", loose)):
            pcd = {pkg: str(root / f"{pkg}_{name}") for pkg in ("jax",
                                                                "port")}
            out[name] = (
                j_video.render_pixels(jc, *jargs, save_separate_pcd=True,
                                      pcd_dir=pcd["jax"]),
                t_video.render_pixels(tc, *targs, save_separate_pcd=True,
                                      pcd_dir=pcd["port"]),
                pcd, len(tc))
    j_video._jit_render.cache_clear()
    j_video._jit_render_mc.cache_clear()
    return out


@pytest.mark.parametrize("split", ["grouped", "loose"])
def test_no_dx_sweep_frames_and_metrics_match_jax(no_dx_sweep, split):
    want, got, _, n = no_dx_sweep[split]
    assert n > 3                  # more cameras than a rig: flows would run
    assert sorted(k for k in got if isinstance(got[k], list)) == \
        sorted(k for k in want if isinstance(want[k], list))
    for key in ("rgbs", "dynamic_rgbs", "static_rgbs"):
        assert len(got.get(key, [])) == len(want.get(key, [])), key
        for g, w in zip(got.get(key, []), want.get(key, [])):
            d = np.rint((g - w) * 255.0)
            assert np.abs(d).max() <= 1, key
            assert (d != 0).mean() <= 1e-3, key
    assert len(got["rgbs"]) == n
    for g, w in zip(got["depths"], want["depths"]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-4)
    for g, w in zip(got["gt_rgbs"], want["gt_rgbs"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got["metrics"].keys() == want["metrics"].keys()
    pv_w, pv_g = want["metrics_per_view"], got["metrics_per_view"]
    for k, tol in (("psnr", 0.01), ("ssim", 1e-3), ("masked_psnr", 0.01),
                   ("masked_ssim", 1e-3)):
        assert len(pv_g[k]) == len(pv_w[k]) == n, k
        np.testing.assert_allclose(pv_g[k], pv_w[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert pv_g["lpips"] == pv_w["lpips"] == [None] * n
    assert got["metrics"]["lpips"] is want["metrics"]["lpips"] is None


@pytest.mark.parametrize("split", ["grouped", "loose"])
def test_no_dx_sweep_writes_no_flow_and_no_split(no_dx_sweep, split):
    want, got, pcd, _ = no_dx_sweep[split]
    for res in (want, got):
        assert not res.get("forward_flows") and not res.get(
            "backward_flows")
    for d in pcd.values():
        assert not os.path.exists(os.path.join(d, "dynamic.ply"))
        assert not os.path.exists(os.path.join(d, "static.ply"))
