"""Port parity of the field's row-gather backward (``ops/gridsample.py``):
the time planes against the JAX package's hand-written VJP of
``_sample_rows_1d`` (through ``sample_time_plane``), the spatial planes
and ``grid_sample_3d`` against ``jax.grad`` of the JAX gathers, in
float32 (atol 1e-5·max|want|, rtol 1e-4) and with bfloat16 grids (atol
2e-2·max|want|, the field's bfloat16 tolerance in
``tests/test_torch_grads.py``: JAX sums the spatial planes' gradient in
bfloat16, the port in float32).  Then, without JAX: ``segment_sum``
against a float64 sum, and a backward pass repeated bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3gaussian_tpu.ops import gridsample as jgs
from s3gaussian_tpu_torch.ops import gridsample as tgs

from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 0.0)}


def _check(got, want, atol_scale, rtol, what):
    for name, g, w in zip(("grid", "coords"), got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=atol_scale * scale, rtol=rtol,
                                   err_msg=f"{what} {name}")


def _grads(fn, grid, coords, w_out, *extra):
    """(d grid, d coords) of sum(fn(grid, coords) · w_out) in both
    packages; grid in its dtype, coords float32."""
    jd, td, _, _ = DTYPES[grid[1]]
    g = np.asarray(grid[0], np.float32)

    def jloss(gr, co):
        return jnp.sum(fn[0](gr, co, *[jnp.asarray(e) for e in extra])
                       * w_out)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(g).astype(jd),
                                           jnp.asarray(coords))
    tg = torch.from_numpy(g).to(td).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    out = fn[1](tg, tc, *[torch.from_numpy(np.asarray(e)) for e in extra])
    got = torch.autograd.grad((out * torch.from_numpy(w_out)).sum(),
                              (tg, tc))
    return got, want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,tval", [(7, 0.3), (25, -0.62), (1, 0.5)])
def test_time_plane_backward_matches_jax_vjp(dtype, rows, tval):
    rng = np.random.default_rng(rows)
    # many points a column, as the field's 1.5 M rows over a 64..512 plane
    plane = rng.normal(size=(4, rows, 11)).astype(np.float32)
    sx = rng.uniform(-1.2, 1.2, 3000).astype(np.float32)
    w_out = rng.normal(size=(3000, 4)).astype(np.float32)
    got, want = _grads((jgs.sample_time_plane, tgs.sample_time_plane),
                       (plane, dtype), sx, w_out, np.float32(tval))
    _, _, atol, rtol = DTYPES[dtype]
    _check(got, want, atol, rtol, "sample_time_plane")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spatial_plane_backward_matches_jax(dtype):
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(5, 9, 13)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (4000, 2)).astype(np.float32)
    w_out = rng.normal(size=(4000, 5)).astype(np.float32)
    got, want = _grads((jgs.grid_sample_2d, tgs.grid_sample_2d),
                       (grid, dtype), coords, w_out)
    _, _, atol, rtol = DTYPES[dtype]
    _check(got, want, atol, rtol, "grid_sample_2d")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grid_sample_3d_backward_matches_jax(dtype):
    rng = np.random.default_rng(6)
    grid = rng.normal(size=(3, 5, 7, 6)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2000, 3)).astype(np.float32)
    w_out = rng.normal(size=(2000, 3)).astype(np.float32)
    got, want = _grads((jgs.grid_sample_3d, tgs.grid_sample_3d),
                       (grid, dtype), coords, w_out)
    _, _, atol, rtol = DTYPES[dtype]
    _check(got, want, atol, rtol, "grid_sample_3d")


@pytest.mark.parametrize("k,n_rows,d", [(0, 5, 3), (1000, 37, 5),
                                        (40000, 3, 4), (5000, 4096, 2)])
def test_segment_sum_matches_a_float64_sum(k, n_rows, d):
    rng = np.random.default_rng(k)
    # skewed keys: one row takes half of them, as a dense plane cell does
    keys = np.where(rng.random(k) < 0.5, n_rows // 2,
                    rng.integers(0, n_rows, k))
    vals = rng.normal(size=(k, d)).astype(np.float32)
    got = tgs.segment_sum(torch.from_numpy(keys), torch.from_numpy(vals),
                          n_rows)
    want = np.zeros((n_rows, d))
    np.add.at(want, keys, vals.astype(np.float64))
    assert got.dtype == torch.float32 and got.shape == (n_rows, d)
    # float32 sums of up to k terms of unit scale
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * max(np.sqrt(k), 1.0) * 4)


def test_field_backward_repeats_bit_for_bit():
    rng = np.random.default_rng(8)
    plane = torch.from_numpy(rng.normal(size=(4, 25, 64)).astype(
        np.float32)).to(torch.bfloat16)
    grid = torch.from_numpy(rng.normal(size=(4, 64, 64)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (20000, 3)).astype(np.float32))
    res = []
    for _ in range(2):
        p, g, c = (v.clone().requires_grad_(True) for v in (plane, grid, x))
        out = (tgs.sample_time_plane(p, c[:, 0], torch.tensor(0.37))
               * tgs.grid_sample_2d(g, c[:, 1:])).sum()
        res.append(torch.autograd.grad(out, (p, g, c)))
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_segment_sum_pieces_stay_short(monkeypatch):
    """Every sum of ``segment_sum``'s levels adds at most PIECE rows (a
    long run would be summed by one warp on the card), with most cells
    empty and one taking half the keys."""
    lens = []
    orig = tgs.sum_ranges

    def record(vals, perm, offs):
        lens.append(int((offs[1:] - offs[:-1]).max()))
        return orig(vals, perm, offs)

    monkeypatch.setattr(tgs, "sum_ranges", record)
    rng = np.random.default_rng(3)
    k, n_rows = 60000, 20000
    keys = np.where(rng.random(k) < 0.5, 17000,
                    rng.integers(5000, 9000, k))
    vals = rng.normal(size=(k, 3)).astype(np.float32)
    got = tgs.segment_sum(torch.from_numpy(keys), torch.from_numpy(vals),
                          n_rows)
    want = np.zeros((n_rows, 3))
    np.add.at(want, keys, vals.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert len(lens) >= 3 and max(lens) <= tgs.PIECE
