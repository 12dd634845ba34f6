"""The binning's key-emission kernel (``csrc/bin_keys.cu`` through
``ops/binning.py::make_pair_keys`` on CUDA tensors) against the plain
emission, and the 32-bit key sort against the int64 sort it replaced.

The ``cuda``-marked tests skip without a GPU.  On the card the kernel's
keys must equal the plain path's on the same CUDA tensors bit for bit
(the exact ellipse–tile cut decides which pairs exist), in both key
layouts (int32 below 4,095 tiles, int64 from there), over the render
budget below and at the pool, the tight rect on and off, oversized rects
that the centre clamp cuts, culled and dead rows with garbage conics,
rect caps 4×4 and 2×2 and tiles of 16 and 8 pixels; the sorted slots,
tile ranges, pair count and pair overflow of the 32-bit sort equal the
int64 sort's; a replayed CUDA graph equals the eager call; a train step
launches the kernel once a camera binning (a camera with its feature
pass: 1; a culled rig of 3: 3).  The file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_bin_kernel.py

The CPU tests hold the dispatch (CPU tensors and two-class emission take
the plain path), the wrapper's checks and the 32-bit sort.
"""

import dataclasses

import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch.ops import binning as tbin
from s3gaussian_tpu_torch.ops import project as pj
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.transforms import projection_matrix

from torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 3001                  # not a multiple of the kernel's blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the key-emission kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def camera(w, h, fov=1.0):
    """A slightly yawed camera at the origin: (view, full projection) as
    row-vector [4, 4] float32, tan(fov_x/2), tan(fov_y/2)."""
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    fovy = 2 * np.arctan(np.tan(fov / 2) * h / w)
    P = projection_matrix(0.01, 100.0, fov, fovy)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(w2c.T), f32((P @ w2c).T), float(np.tan(fov / 2)),
            float(np.tan(fovy / 2)))


def projected(dev, w, h, tile, tight, n=N_ROWS, seed=0):
    """The projection of a seeded scene on ``dev``: rows through and
    beyond the frustum, a tenth behind the camera, dead rows at the
    origin, scales up to a few metres (rects larger than the caps), and
    the conics of every row that is not visible made garbage.  Returns
    (ProjectedGaussians, opacities [N])."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 12.0, n)
    x = rng.uniform(-1.3, 1.3, n) * np.abs(z) * 0.6
    y = rng.uniform(-1.3, 1.3, n) * np.abs(z) * 0.6
    means = np.stack([x, y, z], 1)
    means[:5] = 0.0                                    # dead pool rows
    scales = np.exp(rng.uniform(-4.5, 1.0, (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.002, 0.999, n)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    view, proj, tx, ty = camera(w, h)
    op = f32(opac)
    out = pj.project(f32(means), f32(scales), f32(quats), view.to(dev),
                     proj.to(dev), tx, ty, w, h, tile, tile,
                     opacities=op if tight else None)
    junk = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                         -3.0, 1e38], device=dev)
    idx = torch.randint(0, junk.numel(), (n, 3),
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    conic = torch.where(out.visible[:, None], out.conic, junk[idx])
    return out._replace(conic=conic), op


def keys_both_ways(monkeypatch, proj, grid, max_visible, rect, tile, op):
    """make_pair_keys on the same tensors through the kernel and through
    the plain path."""
    args = (proj, grid[0], grid[1], max_visible, rect, rect, tile, tile)
    got = tbin.make_pair_keys(*args, opacities=op)
    with monkeypatch.context() as m:
        m.setattr(tbin, "kernel_emits", lambda device: False)
        want = tbin.make_pair_keys(*args, opacities=op)
    return got, want


def int64_binning(keys, two_key, n_tiles, bp):
    """The binning as the int64 sort made it: the single key as its
    uint32 value in an int64, one stable sort, the tile ranges."""
    if not two_key:
        keys = keys.to(torch.int64) + tbin.KEY_BIAS
    sorted_key, sorted_slot = torch.sort(keys, stable=True)
    tile = sorted_key >> (32 if two_key else tbin.DEPTH_BITS)
    return (sorted_slot, *tbin.tile_ranges(tile, n_tiles, bp))


def assert_same_binning(pk, n_tiles):
    """The 32-bit sort's binning equals the int64 sort's, with the pair
    budget at the slots and at half the valid pairs (a cut)."""
    m = pk.keys.shape[0]
    n_valid = int(int64_binning(pk.keys, pk.two_key, n_tiles, m)[2])
    assert n_valid > 1
    for bp in (m, n_valid // 2):
        tile, slot = tbin.sort_pairs(pk)
        got = (slot, *tbin.tile_ranges(tile, n_tiles, bp))
        want = int64_binning(pk.keys, pk.two_key, n_tiles, bp)
        for name, a, b in zip(("sorted_slot", "tile_starts", "n_pairs",
                               "overflow_pairs"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got[3]) > 0                          # the budget cut


# --------------------------------------------------------------------------
# CPU: dispatch, the wrapper's checks, the 32-bit sort
# --------------------------------------------------------------------------

@pytest.mark.parametrize("big_budget", [0, 8])
def test_cpu_tensors_take_the_plain_path(monkeypatch, big_budget):
    proj, op = projected("cpu", 96, 64, 8, True, n=400)

    def refused(*a, **kw):
        raise AssertionError("emit_keys called on CPU tensors")

    monkeypatch.setattr(tbin, "emit_keys", refused)
    before = dict(tk.launches)
    pk = tbin.make_pair_keys(proj, 12, 8, 200, 4, 4, 8, 8, opacities=op,
                             big_budget=big_budget)
    assert not pk.by_kernel and pk.keys.dtype == torch.int32
    assert tk.launches == before


@pytest.mark.parametrize("big_budget,rect,by_kernel", [
    (0, 4, True), (8, 4, False), (8, 2, True)])
def test_two_class_emission_takes_the_plain_path(monkeypatch, big_budget,
                                                 rect, by_kernel):
    """Where the kernel could run, single-class emission calls it and
    two-class emission (a rect above 2×2 and a big budget) does not."""
    proj, op = projected("cpu", 96, 64, 8, True, n=400)
    calls = []

    def emit(proj, sel, *a, **kw):
        calls.append(sel.shape[0])
        return torch.zeros(sel.shape[0] * rect * rect, dtype=torch.int32)

    monkeypatch.setattr(tbin, "kernel_emits", lambda device: True)
    monkeypatch.setattr(tbin, "emit_keys", emit)
    pk = tbin.make_pair_keys(proj, 12, 8, 200, rect, rect, 8, 8,
                             opacities=op, big_budget=big_budget)
    assert pk.by_kernel is by_kernel and calls == ([200] if by_kernel else [])
    assert (pk.big_sel is None) is by_kernel


def _emit_args(n=50, nr=20):
    proj, op = projected("cpu", 96, 64, 8, True, n=n)
    sel = torch.arange(nr)
    return dict(proj=proj, sel=sel, sel_visible=proj.visible[:nr].clone(),
                grid_x=12, grid_y=8, rect_w=4, rect_h=4, tile_x=8, tile_y=8,
                opacities=op)


@pytest.mark.parametrize("bad,error", [
    (lambda a: {"sel": a["sel"].int()}, TypeError),
    (lambda a: {"sel": a["sel"][:, None]}, ValueError),
    (lambda a: {"sel_visible": a["sel_visible"].to(torch.uint8)}, TypeError),
    (lambda a: {"sel_visible": a["sel_visible"][:-1]}, ValueError),
    (lambda a: {"proj": a["proj"]._replace(
        tiles_rect=a["proj"].tiles_rect.long())}, TypeError),
    (lambda a: {"proj": a["proj"]._replace(
        tiles_rect=a["proj"].tiles_rect[:, :3])}, ValueError),
    (lambda a: {"proj": a["proj"]._replace(xy=a["proj"].xy.double())},
     TypeError),
    (lambda a: {"proj": a["proj"]._replace(depth=a["proj"].depth[:-1])},
     ValueError),
    (lambda a: {"proj": a["proj"]._replace(conic=a["proj"].conic[:, :2])},
     ValueError),
    (lambda a: {"opacities": a["opacities"].half()}, TypeError),
    (lambda a: {"opacities": a["opacities"][:-1]}, ValueError),
    (lambda a: {"rect_w": 0}, ValueError),
    (lambda a: {"tile_y": 0}, ValueError),
    (lambda a: {}, ValueError),            # CPU tensors: the kernel only
], ids=["sel_dtype", "sel_shape", "visible_dtype", "visible_shape",
        "rect_dtype", "rect_shape", "xy_dtype", "depth_shape",
        "conic_shape", "opacity_dtype", "opacity_shape", "rect_w", "tile_y",
        "cpu"])
def test_wrapper_refuses(bad, error):
    args = _emit_args()
    before = dict(tk.launches)
    with pytest.raises(error):
        tbin.emit_keys(**{**args, **bad(args)})
    assert tk.launches == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_32bit_sort_equals_the_int64_sort(seed):
    """Seeded keys over every tile below 4,095 (those from 2,048 on have
    the int32's sign bit), repeated depths so that the sort's stability
    shows, and invalid slots throughout: the 32-bit sort's slots, tile
    ranges, pair count and overflow equal the int64 sort's."""
    rng = np.random.default_rng(seed)
    m, n_tiles = 20_000, 4094
    tile = rng.integers(0, n_tiles, m)
    tile[: m // 10] = rng.integers(2048, n_tiles, m // 10)
    depth = rng.integers(0, 64, m)             # few depths: many equal keys
    u32 = (tile << tbin.DEPTH_BITS) | depth
    u32[rng.random(m) < 0.2] = tbin.INVALID_KEY
    keys = torch.from_numpy((u32 - tbin.KEY_BIAS).astype(np.int32))
    pk = tbin.PairKeys(sel=None, sel_visible=None, keys=keys, two_key=False,
                       n_visible=None, overflow_rect=None,
                       overflow_visible=None)
    assert int((keys < 0).sum()) > 0 and int((keys >= 0).sum()) > 0
    assert_same_binning(pk, n_tiles)


def test_plain_keys_sort_as_the_int64_path():
    """The plain path's keys of a projection, both layouts."""
    for w, h, tile in ((96, 64, 8), (256, 256, 4)):
        proj, op = projected("cpu", w, h, tile, True, n=600)
        grid = (w // tile, h // tile)
        pk = tbin.make_pair_keys(proj, *grid, 300, 4, 4, tile, tile,
                                 opacities=op)
        assert pk.two_key == (grid[0] * grid[1] >= 4095)
        assert_same_binning(pk, grid[0] * grid[1])


# --------------------------------------------------------------------------
# CUDA: the kernel against the plain path on the card
# --------------------------------------------------------------------------

# (width, height, tile): 96 and 384 tiles; 4,096 and 4,160 (two-key)
LAYOUTS = {"single16": (192, 128, 16), "single8": (192, 128, 8),
           "two16": (1024, 1024, 16), "two8": (520, 512, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("rect", [4, 2])
@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("budget", ["below", "pool"])
def test_kernel_keys_equal_the_plain_keys(cuda_device, monkeypatch, layout,
                                          rect, tight, budget):
    w, h, tile = LAYOUTS[layout]
    proj, op = projected(cuda_device, w, h, tile, tight)
    grid = (-(-w // tile), -(-h // tile))
    max_visible = N_ROWS // 3 if budget == "below" else N_ROWS
    before = tk.launches["bin_keys"]
    got, want = keys_both_ways(monkeypatch, proj, grid, max_visible, rect,
                               tile, op if tight else None)
    assert tk.launches["bin_keys"] == before + 1
    assert got.by_kernel and not want.by_kernel
    two = grid[0] * grid[1] >= 4095
    assert got.two_key is want.two_key is two
    assert got.keys.dtype == want.keys.dtype == (torch.int64 if two
                                                 else torch.int32)
    diff = int((got.keys != want.keys).sum())
    assert torch.equal(got.keys, want.keys), f"{diff} keys differ"
    for k in ("sel", "sel_visible", "n_visible", "overflow_rect",
              "overflow_visible"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    # the scene has oversized rects, culled rows and (below the pool)
    # visible rows past the budget
    assert int(got.overflow_rect) > 0
    assert int((~proj.visible).sum()) > 0
    if budget == "below":
        assert int(got.overflow_visible) > 0
    valid = (got.keys != (tbin.INVALID_KEY - tbin.KEY_BIAS) if not two
             else (got.keys >> 32) != tbin.INVALID_TILE_TWO_KEY)
    assert 0 < int(valid.sum()) < valid.numel()
    assert_same_binning(got, grid[0] * grid[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["single16", "two8"])
def test_replayed_graph_equals_eager(cuda_device, layout):
    from s3gaussian_tpu_torch.ops.rasterizer import bin_pairs

    w, h, tile = LAYOUTS[layout]
    proj, op = projected(cuda_device, w, h, tile, True)
    grid = (-(-w // tile), -(-h // tile))

    def body():
        pk = tbin.make_pair_keys(proj, *grid, N_ROWS // 2, 4, 4, tile, tile,
                                 opacities=op)
        b = bin_pairs(pk, grid[0] * grid[1], 1 << 14)
        return [pk.keys, b.slots, b.tile_starts, b.n_pairs,
                b.overflow_pairs]

    eager = body()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        body()                                     # warm-up
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = tk.captured["bin_keys"]
    with torch.cuda.graph(graph):
        outs = body()
    assert tk.captured["bin_keys"] == captured + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rig", [False, True])
def test_step_launches(cuda_device, rig):
    """A camera with its feature pass emits its keys once a step; a culled
    rig of 3 once a camera; ``bins_kernel`` counts them."""
    from test_torch_project_kernel import _step_cameras, _step_setup

    from s3gaussian_tpu_torch.train import trainer as tr

    state, args = _step_setup(cuda_device)
    cams = _step_cameras(cuda_device, 3)
    if rig:
        args[4] = dataclasses.replace(args[4], cull_before_deform=True,
                                      max_visible=1024)
    before = tk.launches["bin_keys"]
    _, aux = (tr.train_step_multicam(state, cams, "fine", *args) if rig
              else tr.train_step(state, cams[0], "fine", *args))
    torch.cuda.synchronize()
    want = 3 if rig else 1
    assert tk.launches["bin_keys"] - before == want
    assert (int(aux["raster_passes"]), int(aux["bins_reused"]),
            int(aux["bins_kernel"])) == (2 * want, want, want)
