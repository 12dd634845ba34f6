"""The port's LPIPS (``eval/lpips.py``) against the JAX package's
``lpips_jax`` with one weights dict: AlexNet and VGG16 stacks with random
weights (the makers of ``tests/test_lpips.py``) within atol 1e-5 rtol
1e-4, the committed fixture weights at their golden value, and None
without weights."""

import os

import numpy as np
import pytest
import torch

from s3gaussian_tpu.eval import lpips_jax
from s3gaussian_tpu_torch.eval import lpips as tl
from s3gaussian_tpu_torch.eval.metrics import lpips_or_none
from s3gaussian_tpu_torch.weights import lpips_weights_from_numpy
from test_lpips import rand_alex_npz, rand_vgg_npz
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "lpips_alex_fixture.npz")


def images(seed, h=64, w=64):
    r = np.random.default_rng(seed)
    pred = r.random((h, w, 3)).astype(np.float32)
    gt = np.clip(pred + 0.1 * r.random((h, w, 3)).astype(np.float32), 0, 1)
    return pred, gt


@pytest.fixture
def weights_file(tmp_path, monkeypatch):
    def use(wts, net):
        path = tmp_path / f"lpips_{net}.npz"
        np.savez(path, **wts)
        monkeypatch.setenv("S3G_LPIPS_WEIGHTS", str(path))
        lpips_jax._load_weights.cache_clear()
        return str(path)
    yield use
    lpips_jax._load_weights.cache_clear()


@pytest.mark.parametrize("net,maker", [("alex", rand_alex_npz),
                                       ("vgg", rand_vgg_npz)])
@pytest.mark.parametrize("seed", [1, 2])
def test_lpips_matches_jax(weights_file, net, maker, seed):
    weights_file(maker(np.random.default_rng(0)), net)
    pred, gt = images(seed, 64, 80)
    want = lpips_jax.lpips(pred, gt, net=net)
    got = tl.lpips(torch.from_numpy(pred), torch.from_numpy(gt), net=net)
    assert got.dtype == torch.float32 and got.dim() == 0 and want > 0
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-4)


def test_weights_loader_reads_the_npz_dict_of_lpips_jax(weights_file):
    wts = rand_alex_npz(np.random.default_rng(3))
    weights_file(wts, "alex")
    loaded = tl.load_weights("alex", "cpu")
    assert loaded is tl.load_weights("alex", torch.device("cpu"))
    direct = lpips_weights_from_numpy(wts, "cpu")
    assert loaded.keys() == direct.keys() == lpips_jax._load_weights(
        "alex").keys()
    for k, v in direct.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_lpips_of_identical_images_is_zero(weights_file):
    weights_file(rand_alex_npz(np.random.default_rng(3)), "alex")
    img = torch.from_numpy(np.random.default_rng(4).random(
        (64, 64, 3)).astype(np.float32))
    assert abs(float(tl.lpips(img, img))) < 1e-6


def test_lpips_fixture_golden_value(monkeypatch):
    monkeypatch.setenv("S3G_LPIPS_WEIGHTS", FIXTURE)
    lpips_jax._load_weights.cache_clear()
    pred, gt = images(7)
    got = float(tl.lpips(torch.from_numpy(pred), torch.from_numpy(gt)))
    np.testing.assert_allclose(got, 0.0127999, rtol=1e-3)
    np.testing.assert_allclose(got, lpips_jax.lpips(pred, gt), atol=1e-5,
                               rtol=1e-4)
    lpips_jax._load_weights.cache_clear()


def test_lpips_is_none_without_weights(monkeypatch, tmp_path):
    img = torch.zeros(16, 16, 3)
    for env in (None, str(tmp_path / "missing.npz")):
        if env is None:
            monkeypatch.delenv("S3G_LPIPS_WEIGHTS", raising=False)
        else:
            monkeypatch.setenv("S3G_LPIPS_WEIGHTS", env)
        assert lpips_or_none(img, img) is None
        with pytest.raises(FileNotFoundError, match="S3G_LPIPS_WEIGHTS"):
            tl.lpips(img, img)


def test_lpips_leaves_the_tf32_flag_as_it_found_it(weights_file):
    weights_file(rand_alex_npz(np.random.default_rng(3)), "alex")
    pred, gt = images(5)
    prev = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            tl.lpips(torch.from_numpy(pred), torch.from_numpy(gt))
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = prev
