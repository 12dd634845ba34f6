"""The hexplane query's CUDA kernels (``csrc/hexplane.cu`` through
``ops/gridsample.py::hexplane_query``) against the plain version
(``models/hexplane.py::query_hexplane_plain``), and the wrapper's checks.

The ``cuda``-marked tests skip without a GPU.  On the card the kernels
must give the plain version's forward features and every plane's
gradient bit for bit (the same ``segment_sum`` inputs), for bfloat16 and
float32 grids, the default layout at 32 and 8 channels and 4DGaussians'
N3V layout (16 channels, two scales, 150 time rows), coordinates at
exactly ±1 and outside the aabb, and a row count that is not a multiple
of the block's 8 rows; the coordinate
gradient within atol 1e-5·max|plain|, rtol 1e-4 (the channel sums are
taken in another order); a backward repeated, and a replayed CUDA graph,
bit for bit.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hexplane_kernel.py

The CPU tests hold the wrapper's checks (``check_hexplane``) and that a
CPU tensor still takes the plain path.
"""

import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch.models import hexplane as hx
from s3gaussian_tpu_torch.ops import gridsample as gs
from s3gaussian_tpu_torch.ops import tile_kernels as tk

RESOLUTION, MULTIRES = (16, 16, 16, 7), (1, 2, 4, 8)
# 4DGaussians' N3V layout (arguments/waymo_4dgs.py): 16 channels at two
# scales over 150 time rows
N3V_RESOLUTION, N3V_MULTIRES = (16, 16, 16, 150), (1, 2)
AABB = ((2.0, 3.0, 1.5), (-2.0, -1.0, -1.5))     # [max; min], as stored
N_ROWS = 1037                                     # not a multiple of 8
COORD_ATOL, COORD_RTOL = 1e-5, 1e-4
AABB_ON = {}        # the aabb by device type, made before any capture


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hexplane kernels have no CPU "
                    "mode")
    AABB_ON["cuda"] = torch.tensor(AABB, device="cuda")
    return torch.device("cuda")


def field(dev, channels, seed=0, resolution=RESOLUTION, multires=MULTIRES):
    """A hexplane of the default layout (or another) at a small spatial
    resolution, its planes moved off their init so that the time planes
    are not all 1."""
    params = hx.init_hexplane(torch.Generator().manual_seed(seed), channels,
                              resolution, multires, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in params.values():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return params.to(dev)


def points(dev, n=N_ROWS, seed=0):
    """World points spread past the aabb, with rows at its corners and
    faces (normalised coordinates of exactly ±1) and beyond it."""
    rng = np.random.default_rng(seed)
    hi, lo = np.array(AABB[0]), np.array(AABB[1])
    pts = lo + (hi - lo) * rng.uniform(-0.2, 1.2, (n, 3))
    pts[0], pts[1], pts[2] = hi, lo, (hi + lo) / 2
    pts[3] = [hi[0], lo[1], hi[2]]
    pts[4] = [lo[0] - 5.0, hi[1] + 5.0, 0.0]
    pts[5, 0], pts[6, 1], pts[7, 2] = hi[0], lo[1], hi[2]
    return torch.tensor(pts, dtype=torch.float32, device=dev)


def hex_launches(counts):
    """[forward, backward] hexplane launches of a count table of
    ``tile_kernels``."""
    return [counts["hexplane_fwd"], counts["hexplane_bwd"]]


def features_and_grads(query, params, pts, t, dtype, cot):
    """query's features and the gradients of <features, cot> by the points
    and by every plane (t on the points' device sets the aabb's)."""
    pts = pts.detach().requires_grad_(True)
    aabb = AABB_ON[t.device.type]
    out = query(params, pts, t, aabb, len(params) // 6,
                None if dtype == torch.float32 else dtype)
    grads = torch.autograd.grad(out, [pts, *params.values()], cot)
    return out.detach(), grads[0], grads[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("channels,resolution,multires", [
    (32, RESOLUTION, MULTIRES), (8, RESOLUTION, MULTIRES),
    (16, N3V_RESOLUTION, N3V_MULTIRES)], ids=["32", "8", "16-n3v"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_match_plain(cuda_device, dtype, channels, resolution,
                             multires):
    params = field(cuda_device, channels, resolution=resolution,
                   multires=multires)
    pts = points(cuda_device)
    t = torch.tensor(0.37, device=cuda_device)
    cot = torch.randn((N_ROWS, channels * len(multires)),
                      generator=torch.Generator().manual_seed(3)).to(
        cuda_device)
    before = hex_launches(tk.launches)
    got, got_x, got_planes = features_and_grads(hx.query_hexplane, params,
                                                pts, t, dtype, cot)
    torch.cuda.synchronize()
    # one forward launch, one backward a scale
    assert [a - b for a, b in zip(hex_launches(tk.launches), before)] == [
        1, len(multires)]
    want, want_x, want_planes = features_and_grads(hx.query_hexplane_plain,
                                                   params, pts, t, dtype,
                                                   cot)
    assert torch.equal(got, want)
    for name, a, b in zip(params.keys(), got_planes, want_planes):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    scale = float(want_x.abs().max())
    err = (got_x - want_x).abs()
    assert bool((err <= COORD_ATOL * scale
                 + COORD_RTOL * want_x.abs()).all()), float(err.max())


@pytest.mark.cuda
def test_backward_repeats_bit_for_bit(cuda_device):
    params = field(cuda_device, 32, seed=4)
    pts = points(cuda_device, seed=4)
    t = torch.tensor(0.8, device=cuda_device)
    cot = torch.randn((N_ROWS, 128), device=cuda_device)
    first = features_and_grads(hx.query_hexplane, params, pts, t,
                               torch.bfloat16, cot)
    again = features_and_grads(hx.query_hexplane, params, pts, t,
                               torch.bfloat16, cot)
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], again[2]))


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_device):
    """The forward and backward captured as one CUDA graph and replayed
    give the eager call's bits, with the launches counted per replay."""
    params = field(cuda_device, 32, seed=5)
    pts = points(cuda_device, seed=5)
    t = torch.tensor(0.2, device=cuda_device)
    cot = torch.randn((N_ROWS, 128), device=cuda_device)

    def step():
        return features_and_grads(hx.query_hexplane, params, pts, t,
                                  torch.bfloat16, cot)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = hex_launches(tk.captured)
    with torch.cuda.graph(graph):
        out, d_x, d_planes = step()
    assert [a - b for a, b in zip(hex_launches(tk.captured), before)] == [
        1, len(MULTIRES)]
    pts.add_(0.01)          # a replay reads the inputs where they are
    graph.replay()
    torch.cuda.synchronize()
    want, want_x, want_planes = step()
    assert torch.equal(out, want) and torch.equal(d_x, want_x)
    assert all(torch.equal(a, b) for a, b in zip(d_planes, want_planes))


# --------------------------------------------------------------------------
# CPU: the wrapper's checks and the plain path

def cpu_inputs(channels=4, n=5, scales=1):
    x = torch.zeros((n, 3))
    planes = [torch.ones((channels, 3, 4)) for _ in range(6 * scales)]
    return x, torch.tensor(0.5), planes


def test_check_hexplane_takes_good_inputs():
    gs.check_hexplane(*cpu_inputs())
    x, t, planes = cpu_inputs(channels=32, scales=gs.HEX_MAX_SCALES)
    gs.check_hexplane(x, t, [p.to(torch.bfloat16) for p in planes])


@pytest.mark.parametrize("case,error,match", [
    ("per_row_t", ValueError, "one time for every row"),
    ("x_dtype", TypeError, "x must be float32"),
    ("x_shape", ValueError, r"x must be \[N, 3\]"),
    ("plane_dtype", TypeError, "bfloat16 or float32"),
    ("mixed_dtypes", TypeError, "plane 3 is torch.bfloat16"),
    ("channels", ValueError, "33 channels"),
    ("plane_channels", ValueError, r"plane 2 must be \[4, H, W\]"),
    ("plane_count", ValueError, "5 planes"),
    ("scales", ValueError, "54 planes"),
])
def test_check_hexplane_refuses(case, error, match):
    x, t, planes = cpu_inputs()
    if case == "per_row_t":
        t = torch.full((5, 1), 0.5)
    elif case == "x_dtype":
        x = x.double()
    elif case == "x_shape":
        x = torch.zeros((5, 4))
    elif case == "plane_dtype":
        planes = [p.half() for p in planes]
    elif case == "mixed_dtypes":
        planes[3] = planes[3].to(torch.bfloat16)
    elif case == "channels":
        planes = [torch.ones((33, 3, 4)) for _ in planes]
    elif case == "plane_channels":
        planes[2] = torch.ones((5, 3, 4))
    elif case == "plane_count":
        planes = planes[:5]
    elif case == "scales":
        planes = planes * (gs.HEX_MAX_SCALES + 1)
    with pytest.raises(error, match=match):
        gs.check_hexplane(x, t, planes)


def test_hexplane_layout():
    """A spatial plane laid out channel-last, a time plane folded at t into
    the pair rows ``sample_time_plane`` reads."""
    gen = torch.Generator().manual_seed(6)
    planes = [torch.randn((4, 3, 5), generator=gen) for _ in range(12)]
    t = torch.tensor(0.25)
    laid = gs.hexplane_layout(planes, t)
    assert len(laid) == len(planes)
    for i, (p, q) in enumerate(zip(planes, laid)):
        if i % 6 in gs.HEX_TIME_PLANES:
            assert q.shape == (5, 8)
            assert torch.equal(q, gs.time_pair_rows(p, t))
        else:
            assert q.shape == (3, 5, 4) and q.is_contiguous()
            assert torch.equal(q, p.permute(1, 2, 0))


def test_hexplane_query_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        gs.hexplane_query(*cpu_inputs())


def test_cpu_takes_the_plain_path():
    """query_hexplane on CPU tensors is the plain version, launches no
    kernel, and keeps a per-row t."""
    params = field("cpu", 4)
    pts = points("cpu", n=40)
    aabb = AABB_ON["cpu"] = torch.tensor(AABB)
    before = hex_launches(tk.launches)
    for t in (torch.tensor(0.3), torch.full((40, 1), 0.3)):
        got = hx.query_hexplane(params, pts, t, aabb, 2, torch.bfloat16)
        want = hx.query_hexplane_plain(params, pts, t, aabb, 2,
                                       torch.bfloat16)
        assert got.shape == (40, 8) and torch.equal(got, want)
    assert hex_launches(tk.launches) == before
    if not torch.cuda.is_available():
        assert before == [0, 0]
