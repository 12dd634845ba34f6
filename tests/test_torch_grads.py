"""Port parity of the gradients: the rasterizer (through projection, SH,
the tap and the backward compositor), the deformation field and the
hexplane, the hexplane regularizers.

The JAX side is ``jax.grad`` of the JAX functions on the CPU (the
rasterizer with ``use_pallas=False``: the jnp compositor and its
hand-written VJP); the port side is ``torch.autograd`` on CPU tensors (the
plain compositors).  Tolerances:

- rasterizer: atol 2e-5·max|want|, rtol 2e-4 per input
  (``tests/test_rasterize_grads.py:62-65``), plus finite differences of
  the port as ``test_rasterize_grads.py:68-103`` checks JAX;
- field and hexplane in float32: atol 1e-5·max|want|, rtol 1e-4;
- field with bfloat16 planes: atol 2e-2·max|want| on every tensor — the
  two frameworks round the bfloat16 gathers, products and plane-gradient
  sums at different places (JAX sums the spatial planes' gradient in
  bfloat16, the port in float32);
- regularizers: rtol 1e-5 on the value, 1e-5·max|want| on the gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s3gaussian_tpu.config import ModelHiddenParams
from s3gaussian_tpu.config import RasterConfig as JRasterConfig
from s3gaussian_tpu.models import deformation as jdef
from s3gaussian_tpu.models import hexplane as jhx
from s3gaussian_tpu.ops.rasterizer import RasterSettings as JSettings
from s3gaussian_tpu.ops.rasterizer import rasterize as j_rasterize
from s3gaussian_tpu_torch.config import RasterConfig
from s3gaussian_tpu_torch.models import hexplane as thx
from s3gaussian_tpu_torch.ops.rasterizer import RasterSettings as TSettings
from s3gaussian_tpu_torch.ops.rasterizer import rasterize as t_rasterize
from s3gaussian_tpu_torch.weights import _deform_leaves, deformation_from_numpy

from scenes import random_scene
import tiny_config
from torch_threads import one_torch_thread  # noqa: F401

W = H = 32
J_CFG = JRasterConfig(max_visible=128, rect_w=8, rect_h=8, chunk=16,
                      use_pallas=False)
T_CFG = RasterConfig(max_visible=128, rect_w=8, rect_h=8)
BG = np.array([0.3, 0.2, 0.1], np.float32)
NAMES = ("means", "scales", "quats", "opacity", "colors", "tap")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _targets():
    key = jax.random.PRNGKey(7)
    return (np.asarray(jax.random.uniform(key, (3, H, W))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (H, W))) * 5)


def _inputs(sc, sh_deg):
    n = sc["means"].shape[0]
    rng = np.random.default_rng(11)
    colors = (0.3 * rng.normal(size=(n, 16, 3)).astype(np.float32)
              if sh_deg else sc["colors"])
    return [sc["means"], sc["scales"], sc["quats"], sc["opacity"], colors,
            np.zeros((n, 2), np.float32)]


def jax_loss(sc, sh_deg):
    settings = JSettings(H, W, sc["tanfov"], sc["tanfov"], jnp.asarray(BG),
                         1.0, jnp.asarray(sc["view"]), jnp.asarray(sc["proj"]),
                         sh_deg, jnp.asarray([0.1, -0.2, -0.5]))
    tgt_c, tgt_d = _targets()

    def loss(means, scales, quats, opacity, colors, tap):
        color, _, depth, _ = j_rasterize(
            settings, means, opacity, scales=scales, rotations=quats,
            shs=colors if sh_deg else None,
            colors_precomp=None if sh_deg else colors, mean2d_tap=tap,
            cfg=J_CFG)
        return (jnp.mean(jnp.abs(color - tgt_c))
                + 0.3 * jnp.mean((depth - tgt_d) ** 2))

    return loss


def torch_loss(sc, sh_deg, alive=None, campos=(0.1, -0.2, -0.5)):
    settings = TSettings(H, W, sc["tanfov"], sc["tanfov"], t(BG), 1.0,
                         t(sc["view"]), t(sc["proj"]), sh_deg, t(campos))
    tgt_c, tgt_d = (t(x) for x in _targets())

    def loss(means, scales, quats, opacity, colors, tap):
        color, _, depth, _ = t_rasterize(
            settings, means, opacity, scales=scales, rotations=quats,
            shs=colors if sh_deg else None,
            colors_precomp=None if sh_deg else colors, mean2d_tap=tap,
            alive=alive, cfg=T_CFG)
        return (torch.mean(torch.abs(color - tgt_c))
                + 0.3 * torch.mean((depth - tgt_d) ** 2))

    return loss


def torch_grads(loss, args):
    leaves = [t(a).requires_grad_(True) for a in args]
    value = loss(*leaves)
    return value, torch.autograd.grad(value, leaves)


@pytest.mark.parametrize("seed,sh_deg", [(11, 0), (12, 3)])
def test_rasterize_grads_match_jax(seed, sh_deg):
    sc = random_scene(n=40, seed=seed, w=W, h=H)
    args = _inputs(sc, sh_deg)
    want_v, want = jax.value_and_grad(jax_loss(sc, sh_deg),
                                      argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    got_v, got = torch_grads(torch_loss(sc, sh_deg), args)
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-5)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * scale,
                                   rtol=2e-4, err_msg=name)
    assert (np.abs(got[5].numpy()).sum(1) > 0).sum() > 5


@pytest.mark.parametrize("argnum", [0, 1, 3, 4])
def test_rasterize_finite_differences(argnum):
    """The port's gradients against central differences (the probes and
    the majority rule of test_rasterize_grads.py:68-103)."""
    sc = random_scene(n=12, seed=3, w=W, h=H, opacity_range=(0.3, 0.7))
    args = _inputs(sc, 0)
    loss = torch_loss(sc, 0)
    _, grads = torch_grads(loss, args)
    g = grads[argnum].numpy().reshape(-1)
    rng = np.random.default_rng(0)
    x0 = np.asarray(args[argnum], np.float64)
    flat = x0.reshape(-1)
    idx = np.argsort(-np.abs(g))[:8].tolist()
    idx += rng.integers(0, flat.size, 2).tolist()
    eps, ok, fails = 1e-3, 0, []
    for i in idx:
        vals = []
        for sgn in (1, -1):
            xs = flat.copy()
            xs[i] += sgn * eps
            a = [t(x) for x in args]
            a[argnum] = t(xs.reshape(x0.shape))
            with torch.no_grad():
                vals.append(float(loss(*a)))
        fd = (vals[0] - vals[1]) / (2 * eps)
        if abs(fd - g[i]) < max(3e-2 * max(abs(fd), abs(g[i])), 3e-4):
            ok += 1
        else:
            fails.append(f"[{i}]: fd={fd:.6g} grad={g[i]:.6g}")
    assert ok >= len(idx) - 2, f"too many FD mismatches: {fails}"


def test_rasterize_grads_finite_on_dead_and_culled_rows():
    """Dead pool slots (identity quats at the origin, which is also the
    camera centre here, masked by ``alive``) and rows behind the camera
    get finite, zero gradients."""
    sc = random_scene(n=30, seed=5, w=W, h=H)
    args = _inputs(sc, 3)
    args[0] = args[0].copy()
    args[0][:4] = 0.0                             # dead slots at the origin
    args[2] = args[2].copy()
    args[2][:4] = [1.0, 0.0, 0.0, 0.0]
    args[0][4:7, 2] = -2.0                        # behind the camera
    alive = torch.ones(30, dtype=torch.bool)
    alive[:4] = False
    _, grads = torch_grads(torch_loss(sc, 3, alive=alive, campos=(0, 0, 0)),
                           args)
    for name, g in zip(NAMES, grads):
        assert torch.isfinite(g).all(), name
        assert (g[:7] == 0).all(), name
    assert (grads[0][7:] != 0).any()


def _field(hp, seed):
    tree = jdef.init_deformation(jax.random.PRNGKey(seed), hp)
    # non-constant time planes so every plane's gradient matters
    tree["grid"] = {k: v * (1.0 + 0.2 * jax.random.normal(
        jax.random.PRNGKey(i), v.shape))
        for i, (k, v) in enumerate(sorted(tree["grid"].items()))}
    return tree, deformation_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), hp, device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_deformation_field_grads_match_jax(bf16):
    hp = ModelHiddenParams(**{**tiny_config.ModelHiddenParams,
                              "grid_compute_bf16": bf16})
    aabb = np.array([[2.0, 2.0, 2.0], [-2.0, -2.0, -1.0]], np.float32)
    tree, field = _field(hp, 5)
    rng = np.random.default_rng(7)
    n = 300
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    scales = rng.normal(-3, 0.5, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.normal(size=(n, 1)).astype(np.float32)
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32)
    cot = {"xyz": rng.normal(size=(n, 3)), "shs": rng.normal(size=(n, 16, 3)),
           "feat": rng.normal(size=(n, 3))}
    tval = np.float32(0.41)

    def jloss(params, x):
        out = jdef.apply_deformation(params, hp, jnp.asarray(aabb), x,
                                     jnp.asarray(scales), jnp.asarray(rot),
                                     jnp.asarray(opac), jnp.asarray(shs),
                                     jnp.asarray(tval))
        return sum(jnp.vdot(jnp.asarray(cot[k], jnp.float32),
                            getattr(out, k)) for k in cot)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(xyz))
    x = t(xyz).requires_grad_(True)
    out = field(x, t(scales), t(rot), t(opac), t(shs), torch.tensor(tval),
                t(aabb))
    tl = sum((t(cot[k]) * getattr(out, k)).sum() for k in cot)
    names = dict(field.named_parameters())
    got = torch.autograd.grad(tl, [x] + list(names.values()))
    got_p = dict(zip(names, got[1:]))

    tol = 2e-2 if bf16 else 1e-5
    rtol = 0.0 if bf16 else 1e-4

    def close(g, w, what):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), w, atol=tol * scale, rtol=rtol,
                                   err_msg=what)

    close(got[0], want_x, "xyz")
    for name, path, transpose in _deform_leaves(field):
        w = want_p
        for k in path:
            w = w[k]
        close(got_p[name], np.asarray(w).T if transpose else w, name)
    assert any(float(np.abs(np.asarray(want_p["grid"][k])).max()) > 0
               for k in want_p["grid"])


def test_compute_regulation_matches_jax():
    params = jhx.init_hexplane(jax.random.PRNGKey(1), 4, (8, 8, 8, 5), (1, 2))
    params = {k: v * (1.0 + 0.3 * jax.random.normal(jax.random.PRNGKey(i),
                                                    v.shape))
              for i, (k, v) in enumerate(sorted(params.items()))}
    weights = (0.01, 0.0001, 0.0003)

    def jreg(p):
        return jhx.compute_regulation(p, 2, *weights)

    want_v, want_g = jax.value_and_grad(jreg)(params)
    tparams = {k: t(v).requires_grad_(True) for k, v in params.items()}
    got_v = thx.compute_regulation(tparams, 2, *weights)
    got_g = torch.autograd.grad(got_v, list(tparams.values()))
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-5)
    for (k, _), g in zip(tparams.items(), got_g):
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    for fn in ("plane_tv", "time_smoothness", "l1_time"):
        np.testing.assert_allclose(
            getattr(thx, fn)(tparams, 2).item(),
            float(getattr(jhx, fn)(params, 2)), rtol=1e-5, err_msg=fn)
