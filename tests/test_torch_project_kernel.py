"""The projection's and the SH colour's CUDA kernels (``csrc/project.cu``
through ``ops/project.py::project`` and ``sh_to_color``) against the
plain path (``build_cov3d`` + ``project_gaussians``,
``sh_to_color_plain``), and the wrappers' checks.

The ``cuda``-marked tests skip without a GPU.  On the card the kernels
must give the plain path's tile rects, radii and visibility exactly and
its xy, depth, conic and colours bit for bit on the PyTorch and CUDA
build they were measured on (``MEASURED_BUILD``: the kernels repeat the
plain arithmetic as that build runs it on the card, its ``@`` and
``torch.linalg.norm`` included), to 1e-6 relative on another, over the
tight rect on and off, the tap and the alive mask on and off, a cull
margin, tan(fov/2) as a float and as a 0-d tensor, rows behind the near
plane, at the origin, on the clamp bounds and with a singular 2D
covariance (det 0), SH degrees 0-3 as an int and as a tensor; every
input's gradient against ``autograd.grad`` of the plain path within atol
1e-5·max|plain| + rtol 1e-4 (the kernels sum in another order; the
projection's max|plain| over the visible rows and the rest apart); a
backward repeated, and a replayed CUDA graph, bit
for bit; the launches of a train step (a camera with its feature pass:
2 / 2 / 1 / 1 of ``project_fwd`` / ``project_bwd`` / ``sh_fwd`` /
``sh_bwd``; a culled rig of 3: 9 / 6 / 3 / 3) and two eager steps from
one state bit for bit.  The file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_project_kernel.py

The CPU tests hold the wrappers' checks and that CPU tensors take the
plain path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch.ops import project as pj
from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.transforms import projection_matrix

from torch_threads import one_torch_thread  # noqa: F401

W, H = 96, 64
N_ROWS = 1037                  # not a multiple of the blocks' 128 rows
FLOAT_RTOL = 1e-6
# (torch.__version__, torch.version.cuda) on which the kernels' floats were
# measured equal to the plain path's bit for bit (an H100); another build
# may order cuBLAS's or the norm's sums otherwise
MEASURED_BUILD = ("2.11.0+cu128", "12.8")
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
KERNELS = ("project_fwd", "project_bwd", "sh_fwd", "sh_bwd")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the projection kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def camera(fov=1.0, yaw=0.3):
    """A yawed camera at (0.2, -0.1, -0.5): (view, full projection) as
    row-vector [4, 4] float32, and tan(fov/2)."""
    a = yaw
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ np.array([0.2, -0.1, -0.5])
    P = projection_matrix(0.01, 100.0, fov, fov * H / W)
    view = w2c.T
    full = (P @ w2c).T
    return (view.astype(np.float32), full.astype(np.float32),
            float(np.tan(fov / 2)), float(np.tan(fov * H / W / 2)))


def scene(n=N_ROWS, seed=0):
    """Rows spread over the frustum and beyond it, some behind the near
    plane, a few at the origin, with anisotropic scales."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 9.0, n)
    x = rng.uniform(-1.2, 1.2, n) * np.abs(z) * 0.6
    y = rng.uniform(-1.2, 1.2, n) * np.abs(z) * 0.5
    means = np.stack([x, y, z], 1)
    means[:4] = 0.0                                   # dead pool slots
    scales = np.exp(rng.uniform(-4.0, -0.5, (n, 3)))
    quats = rng.normal(size=(n, 4))                    # not normalised
    opac = rng.uniform(0.01, 0.99, n)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return dict(means=f32(means), scales=f32(scales), quats=f32(quats),
                opac=f32(opac), alive=torch.from_numpy(rng.random(n) > 0.1),
                tap=f32(np.zeros((n, 2))))


def on(dev, *xs):
    return [x if not isinstance(x, torch.Tensor) else x.to(dev) for x in xs]


def plain_project(means, scales, quats, view, proj, tx, ty, width=W,
                  height=H, **kw):
    return pj.project_gaussians(means, pj.build_cov3d(scales, quats), view,
                                proj, tx, ty, width, height, **kw)


def same_floats(got, want, what, atol_share=0.0):
    """Bit for bit on MEASURED_BUILD, to FLOAT_RTOL on another build."""
    if (torch.__version__, torch.version.cuda) == MEASURED_BUILD:
        diff = int((got != want).sum())
        assert torch.equal(got, want), f"{what}: {diff} entries differ"
    else:
        close(got, want, FLOAT_RTOL, atol_share, what)


def close(got, want, rtol, atol_share, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = (got - want).abs()
    ok = err <= atol_share * scale + rtol * want.abs()
    assert bool(ok.all()), (f"{what}: max abs err {float(err.max()):.3e} "
                            f"(scale {scale:.3e})")


def close_grads(got, want, visible, what):
    """``close`` at the gradients' tolerance, max|plain| taken over the
    visible rows and over the rest apart: rows at the near plane have
    gradients orders above an ordinary row's and would set its scale."""
    for rows, part in ((visible, "visible"), (~visible, "other")):
        if bool(rows.any()):
            close(got[rows], want[rows], GRAD_RTOL, GRAD_ATOL,
                  f"{what} ({part} rows)")


# --------------------------------------------------------------------------
# CPU: the plain path and the wrappers' checks
# --------------------------------------------------------------------------

def test_cpu_takes_the_plain_path():
    sc = scene(200)
    view, proj, tx, ty = camera()
    view, proj = torch.from_numpy(view), torch.from_numpy(proj)
    before = {k: tk.launches[k] for k in KERNELS}
    got = pj.project(sc["means"], sc["scales"], sc["quats"], view, proj, tx,
                     ty, W, H, alive=sc["alive"], radius_margin=2.0,
                     opacities=sc["opac"])
    want = plain_project(sc["means"], sc["scales"], sc["quats"], view, proj,
                         tx, ty, alive=sc["alive"], radius_margin=2.0,
                         opacities=sc["opac"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    shs = torch.randn(200, 16, 3, generator=torch.Generator().manual_seed(1))
    campos = torch.tensor([0.2, -0.1, -0.5])
    for deg in (2, torch.tensor(2, dtype=torch.int32)):
        assert torch.equal(pj.sh_to_color(shs, sc["means"], campos, deg),
                           pj.sh_to_color_plain(shs, sc["means"], campos,
                                                deg))
    assert {k: tk.launches[k] for k in KERNELS} == before


def test_rasterizer_refuses_a_scale_modifier():
    """The projection takes the activated scales as they are: a settings'
    scale_modifier other than 1 is refused, not dropped."""
    from s3gaussian_tpu_torch.ops.rasterizer import (RasterSettings,
                                                     project_and_pack)
    sc = scene(16)
    view, proj, tx, ty = camera()
    settings = RasterSettings(H, W, tx, ty, torch.zeros(3), 1.5,
                              torch.from_numpy(view), torch.from_numpy(proj),
                              0, torch.zeros(3))
    with pytest.raises(ValueError, match="scale_modifier 1.5"):
        project_and_pack(settings, sc["means"], sc["opac"][:, None],
                         sc["scales"], sc["quats"],
                         colors_precomp=torch.zeros(16, 3))


def _project_inputs(n=8):
    view, proj, tx, ty = camera()
    return dict(means3d=torch.zeros(n, 3), scales=torch.ones(n, 3),
                rotations=torch.ones(n, 4), view=torch.from_numpy(view),
                proj=torch.from_numpy(proj), tanfovx=tx,
                tanfovy=torch.tensor(ty), mean2d_tap=torch.zeros(n, 2),
                alive=torch.ones(n, dtype=torch.bool),
                opacities=torch.ones(n, 1))


def test_check_project_takes_good_inputs():
    pj.check_project(**_project_inputs())


@pytest.mark.parametrize("case,error,match", [
    ("means_shape", ValueError, "means3d must be"),
    ("scales_shape", ValueError, "scales must be"),
    ("rotations_dtype", TypeError, "rotations must be float32"),
    ("view_shape", ValueError, "view must be"),
    ("tan_shape", ValueError, "tanfovy must be"),
    ("tan_type", TypeError, "tanfovx must be a number"),
    ("tap_shape", ValueError, "mean2d_tap must be"),
    ("alive_dtype", ValueError, "alive must be"),
    ("opacities_shape", ValueError, "opacities must be"),
    ("camera_grad", ValueError, "no gradient to the camera"),
])
def test_check_project_refuses(case, error, match):
    kw = _project_inputs()
    if case == "means_shape":
        kw["means3d"] = torch.zeros(8, 4)
    elif case == "scales_shape":
        kw["scales"] = torch.ones(7, 3)
    elif case == "rotations_dtype":
        kw["rotations"] = kw["rotations"].double()
    elif case == "view_shape":
        kw["view"] = kw["view"][:3]
    elif case == "tan_shape":
        kw["tanfovy"] = torch.tensor([0.5])
    elif case == "tan_type":
        kw["tanfovx"] = "0.5"
    elif case == "tap_shape":
        kw["mean2d_tap"] = torch.zeros(8, 3)
    elif case == "alive_dtype":
        kw["alive"] = torch.ones(8)
    elif case == "opacities_shape":
        kw["opacities"] = torch.ones(8, 2)
    elif case == "camera_grad":
        kw["view"] = kw["view"].requires_grad_(True)
    with pytest.raises(error, match=match):
        pj.check_project(**kw)


def _sh_inputs(n=8, k=16):
    return dict(shs=torch.zeros(n, k, 3), means3d=torch.zeros(n, 3),
                campos=torch.zeros(3),
                active_degree=torch.tensor(3, dtype=torch.int32))


def test_check_sh_takes_good_inputs():
    pj.check_sh(**_sh_inputs())
    for k, deg in ((1, 0), (4, 1), (9, 2), (16, 3)):
        pj.check_sh(**{**_sh_inputs(k=k), "active_degree": deg})


@pytest.mark.parametrize("case,error,match", [
    ("coefficients", ValueError, "shs must be"),
    ("shs_dtype", TypeError, "shs must be float32"),
    ("means_shape", ValueError, "means3d must be"),
    ("campos_shape", ValueError, "campos must be"),
    ("degree_above", ValueError, "SH degree 2 not in"),
    ("degree_below", ValueError, "SH degree -1 not in"),
    ("degree_float_tensor", TypeError, "0-d integer tensor"),
    ("degree_shape", TypeError, "0-d integer tensor"),
    ("campos_grad", ValueError, "no gradient to the camera"),
])
def test_check_sh_refuses(case, error, match):
    kw = _sh_inputs()
    if case == "coefficients":
        kw["shs"] = torch.zeros(8, 5, 3)
    elif case == "shs_dtype":
        kw["shs"] = kw["shs"].half()
    elif case == "means_shape":
        kw["means3d"] = torch.zeros(9, 3)
    elif case == "campos_shape":
        kw["campos"] = torch.zeros(4)
    elif case == "degree_above":
        kw.update(shs=torch.zeros(8, 4, 3), active_degree=2)
    elif case == "degree_below":
        kw["active_degree"] = -1
    elif case == "degree_float_tensor":
        kw["active_degree"] = torch.tensor(2.0)
    elif case == "degree_shape":
        kw["active_degree"] = torch.tensor([2])
    elif case == "campos_grad":
        kw["campos"] = kw["campos"].requires_grad_(True)
    with pytest.raises(error, match=match):
        pj.check_sh(**kw)


def test_other_devices_are_refused():
    kw = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
          for k, v in _project_inputs().items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pj.project(kw["means3d"], kw["scales"], kw["rotations"], kw["view"],
                   kw["proj"], kw["tanfovx"], kw["tanfovy"], W, H)
    sh = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
          for k, v in _sh_inputs().items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pj.sh_to_color(sh["shs"], sh["means3d"], sh["campos"], 3)


# --------------------------------------------------------------------------
# CUDA: the kernels against the plain path
# --------------------------------------------------------------------------

def _grads(run, inputs, cots):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = run(*xs)
    grads = torch.autograd.grad([o for o in outs], xs, cots,
                                allow_unused=True)
    return [o.detach() for o in outs], [
        torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("tight,tap,alive,margin,fov_tensor", [
    (False, False, False, 0.0, False),
    (True, True, True, 0.0, True),
    (True, False, True, 8.0, False),
    (False, True, False, 3.5, True),
])
def test_project_kernels_match_plain(cuda_device, tight, tap, alive, margin,
                                     fov_tensor):
    sc = scene()
    view, proj, tx, ty = camera()
    view, proj = torch.from_numpy(view), torch.from_numpy(proj)
    if fov_tensor:
        tx, ty = torch.tensor(tx), torch.tensor(ty)
    dev = cuda_device
    means, scales, quats, opac, alv, tp, view, proj, tx, ty = on(
        dev, sc["means"], sc["scales"], sc["quats"], sc["opac"], sc["alive"],
        sc["tap"], view, proj, tx, ty)
    kw = dict(alive=alv if alive else None, radius_margin=margin,
              opacities=opac if tight else None)
    gen = torch.Generator(device=dev).manual_seed(7)
    cots = [torch.randn((N_ROWS, 2), generator=gen, device=dev),
            torch.randn((N_ROWS,), generator=gen, device=dev),
            torch.randn((N_ROWS, 3), generator=gen, device=dev)]
    inputs = [means, scales, quats] + ([tp] if tap else [])

    def run(project):
        def f(m, s, q, t=None):
            out = project(m, s, q, view, proj, tx, ty, mean2d_tap=t, **kw)
            return out.xy, out.depth, out.conic
        return f

    def kernel(m, s, q, view, proj, tx, ty, **k):
        return pj.project(m, s, q, view, proj, tx, ty, W, H, **k)

    before = tk.launches["project_fwd"]
    got_full = kernel(means, scales, quats, view, proj, tx, ty,
                      mean2d_tap=tp if tap else None, **kw)
    assert tk.launches["project_fwd"] == before + 1
    want_full = plain_project(means, scales, quats, view, proj, tx, ty,
                              mean2d_tap=tp if tap else None, **kw)
    for name in ("radius", "tiles_rect", "visible"):
        g, w = getattr(got_full, name), getattr(want_full, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert bool(want_full.visible.any()) and not bool(want_full.visible.all())
    for name in ("xy", "depth", "conic"):
        same_floats(getattr(got_full, name), getattr(want_full, name), name)

    before = tk.launches["project_bwd"]
    _, got = _grads(run(kernel), inputs, cots)
    assert tk.launches["project_bwd"] == before + 1
    _, want = _grads(run(plain_project), inputs, cots)
    for name, g, w in zip(("means3d", "scales", "rotations", "tap"), got,
                          want):
        assert bool(torch.isfinite(g).all()), name
        close_grads(g, w, want_full.visible, f"d {name}")


def edge_rows(dev, tx):
    """Rows on the clamp bounds of a yawless camera at the origin (view
    x / z exactly ±1.3·tan, as PyTorch rounds it), at the near plane and
    beyond the bound, and a camera whose view columns 0 and 1 are equal:
    on a square image its two J rows are equal, so a wide Gaussian's 2D
    covariance is singular (det exactly 0 once the 0.3 low-pass rounds
    away).  (view, proj, means, scale) a camera."""
    P = projection_matrix(0.01, 100.0, 1.0, 1.0).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    lim = float((1.3 * tx).item()) if isinstance(tx, torch.Tensor) else float(
        np.float32(1.3 * tx))
    z = np.array([2.0, 2.0, 4.0, 0.2, 0.25, 3.0], np.float32)
    x = np.array([lim * 2.0, -lim * 2.0, 0.1, 0.0, 0.05, 5.0 * 3.0],
                 np.float32)
    y = np.array([0.0, lim * 2.0, -lim * 4.0, 0.1, 0.0, 0.0], np.float32)
    means = np.stack([x, y, z], 1)
    singular = np.eye(4, dtype=np.float32)
    singular[0, 1], singular[1, 1] = 1.0, 0.0   # p_view = (m0, m0, m2, 1)
    wide = np.stack([np.zeros(8), np.zeros(8),
                     np.linspace(3.0, 9.0, 8)], 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    return [(t(view), t(view @ P.T), t(means), 0.3),
            (t(singular), t(singular @ P.T), t(wide), 4000.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("fov_tensor", [False, True])
def test_project_edge_rows_match_plain(cuda_device, fov_tensor):
    dev = cuda_device
    tx = ty = float(np.tan(0.5))
    if fov_tensor:
        tx = ty = torch.tensor(tx, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for i, (view, proj, means, s) in enumerate(edge_rows(dev, tx)):
        n = means.shape[0]
        # anisotropic: an isotropic Gaussian's rotation has no gradient
        scales = s * torch.tensor([[1.0, 0.5, 0.25]], device=dev).expand(
            n, 3).contiguous()
        quats = torch.randn((n, 4), generator=gen, device=dev)
        cots = [torch.randn((n, 2), generator=gen, device=dev),
                torch.randn((n,), generator=gen, device=dev),
                torch.randn((n, 3), generator=gen, device=dev)]

        def run(project):
            def f(m, sc, q):
                out = project(m, sc, q, view, proj, tx, ty, W, W)
                return out.xy, out.depth, out.conic
            return f

        got = pj.project(means, scales, quats, view, proj, tx, ty, W, W)
        want = plain_project(means, scales, quats, view, proj, tx, ty, W, W)
        for name in ("radius", "tiles_rect", "visible"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        for name in ("xy", "depth", "conic"):
            same_floats(getattr(got, name), getattr(want, name), name)
        if i == 1:      # the singular camera: det 0, so never visible
            assert not bool(want.visible.any())
            c = want.conic
            # det_safe = 1: the conic is (c, -b, a) with a = b = c
            assert torch.equal(c[:, 0], c[:, 2])
            assert torch.equal(c[:, 0], -c[:, 1])
        _, g = _grads(run(pj.project), [means, scales, quats], cots)
        _, w = _grads(run(plain_project), [means, scales, quats], cots)
        for name, a, b in zip(("means3d", "scales", "rotations"), g, w):
            close_grads(a, b, want.visible, f"edge camera {i}: d {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 4])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_sh_kernels_match_plain(cuda_device, k, degree, as_tensor):
    max_deg = {16: 3, 4: 1}[k]
    if degree > max_deg and not as_tensor:
        pytest.skip("a Python degree above the coefficients' is refused")
    dev = cuda_device
    sc = scene()
    gen = torch.Generator(device=dev).manual_seed(degree)
    shs = 0.5 * torch.randn((N_ROWS, k, 3), generator=gen, device=dev)
    means = sc["means"].to(dev)
    campos = torch.tensor([0.2, -0.1, -0.5], device=dev)
    means[4] = campos                    # a dead slot at the camera centre
    deg = (torch.tensor(degree, dtype=torch.int32, device=dev) if as_tensor
           else degree)
    cot = torch.randn((N_ROWS, 3), generator=gen, device=dev)

    def run(f):
        return lambda s, m: (f(s, m, campos, deg),)

    before = [tk.launches["sh_fwd"], tk.launches["sh_bwd"]]
    (got,), g = _grads(run(pj.sh_to_color), [shs, means], [cot])
    assert [tk.launches["sh_fwd"], tk.launches["sh_bwd"]] == [
        before[0] + 1, before[1] + 1]
    (want,), w = _grads(run(pj.sh_to_color_plain), [shs, means], [cot])
    same_floats(got, want, "colour", FLOAT_RTOL)
    for name, a, b in zip(("shs", "means3d"), g, w):
        assert bool(torch.isfinite(a).all()), name
        close(a, b, GRAD_RTOL, GRAD_ATOL, f"d {name}")


@pytest.mark.cuda
def test_backwards_repeat_bit_for_bit(cuda_device):
    dev = cuda_device
    sc = scene(seed=3)
    view, proj, tx, ty = camera()
    view, proj = torch.from_numpy(view).to(dev), torch.from_numpy(proj).to(dev)
    means, scales, quats, opac, tap = on(dev, sc["means"], sc["scales"],
                                         sc["quats"], sc["opac"], sc["tap"])
    shs = torch.randn((N_ROWS, 16, 3), device=dev)
    campos = torch.tensor([0.2, -0.1, -0.5], device=dev)
    cots = [torch.randn((N_ROWS, 2), device=dev),
            torch.randn((N_ROWS,), device=dev),
            torch.randn((N_ROWS, 3), device=dev),
            torch.randn((N_ROWS, 3), device=dev)]

    def f(m, s, q, t, sh):
        out = pj.project(m, s, q, view, proj, tx, ty, W, H, mean2d_tap=t,
                         opacities=opac)
        return out.xy, out.depth, out.conic, pj.sh_to_color(sh, m, campos, 3)

    runs = [_grads(f, [means, scales, quats, tap, shs], cots)
            for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_device):
    dev = cuda_device
    sc = scene(seed=4)
    view, proj, tx, ty = camera()
    view, proj = torch.from_numpy(view).to(dev), torch.from_numpy(proj).to(dev)
    tx, ty = torch.tensor(tx, device=dev), torch.tensor(ty, device=dev)
    static = [x.clone().requires_grad_(True) for x in on(
        dev, sc["means"], sc["scales"], sc["quats"])]
    static.append(torch.randn((N_ROWS, 16, 3), device=dev,
                              requires_grad=True))
    campos = torch.tensor([0.2, -0.1, -0.5], device=dev)
    deg = torch.tensor(2, dtype=torch.int32, device=dev)
    alive = sc["alive"].to(dev)
    cots = [torch.randn((N_ROWS, 2), device=dev),
            torch.randn((N_ROWS,), device=dev),
            torch.randn((N_ROWS, 3), device=dev),
            torch.randn((N_ROWS, 3), device=dev)]

    def body():
        m, s, q, sh = static
        out = pj.project(m, s, q, view, proj, tx, ty, W, H, alive=alive)
        outs = (out.xy, out.depth, out.conic,
                pj.sh_to_color(sh, m, campos, deg))
        grads = torch.autograd.grad(outs, static, cots)
        return [o.detach() for o in outs] + [out.radius, out.tiles_rect,
                                             out.visible] + list(grads)

    eager = body()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()                                     # warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = {k: tk.captured[k] for k in KERNELS}
    with torch.cuda.graph(graph):
        outs = body()
    assert {k: tk.captured[k] - captured[k] for k in KERNELS} == dict.fromkeys(
        KERNELS, 1)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


def _step_setup(dev, seed=10):
    """A small fine-stage state and its step arguments."""
    from s3gaussian_tpu_torch.config import (ModelHiddenParams,
                                             OptimizationParams,
                                             PipelineParams, RasterConfig)
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train.trainer import init_state

    rng = np.random.default_rng(seed)
    n = 1500
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 8, n)], 1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    hp = ModelHiddenParams(net_width=16, multires=[1, 2],
                           kplanes_config={"grid_dimensions": 2,
                                           "input_coordinate_dim": 4,
                                           "output_coordinate_dim": 8,
                                           "resolution": [8, 8, 8, 5]})
    cfg = RasterConfig(max_visible=2048, pair_budget=1 << 18, rect_w=8,
                       rect_h=8, tile_x=8, tile_y=8)
    state = init_state(create_from_pcd(pts, cols, 2048, device=dev),
                       DeformationField(hp, torch.Generator().manual_seed(0),
                                        dev),
                       torch.tensor([[9.0] * 3, [-9.0] * 3], device=dev))
    return state, [3, hp, OptimizationParams(), PipelineParams(), cfg, 5.0,
                   torch.zeros(3, device=dev)]


def _step_cameras(dev, n):
    from s3gaussian_tpu_torch.data.cameras import make_camera

    rng = np.random.default_rng(20)
    cams = []
    for i in range(n):
        a = np.deg2rad(8.0 * (i % 3 - 1))
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cams.append(make_camera(
            R, np.zeros(3), 1.0, 0.8, W, H, time=0.3 + 0.1 * i,
            image=rng.random((H, W, 3)).astype(np.float32),
            depth_map=rng.uniform(1, 8, (H, W)).astype(np.float32),
            feat_map=rng.random((H, W, 3)).astype(np.float32), device=dev))
    return cams


@pytest.mark.cuda
@pytest.mark.parametrize("rig", [False, True])
def test_step_launches_and_repeats_bit_for_bit(cuda_device, rig):
    """A camera with its feature pass launches 2 / 2 / 1 / 1 of
    project_fwd / project_bwd / sh_fwd / sh_bwd a step; a rig of 3 with
    the cull 9 / 6 / 3 / 3; two eager steps from one state give the same
    bits."""
    from s3gaussian_tpu_torch.train import trainer as tr
    from s3gaussian_tpu_torch.train.checkpoints import state_tensors
    from s3gaussian_tpu_torch.train.graphs import clone_state

    state, args = _step_setup(cuda_device)
    cams = _step_cameras(cuda_device, 3)
    if rig:
        args[4] = dataclasses.replace(args[4], cull_before_deform=True,
                                      max_visible=1024)
    runs = []
    for _ in range(2):
        before = {k: tk.launches[k] for k in KERNELS}
        st = clone_state(state)
        st, aux = (tr.train_step_multicam(st, cams, "fine", *args) if rig
                   else tr.train_step(st, cams[0], "fine", *args))
        torch.cuda.synchronize()
        counts = [tk.launches[k] - before[k] for k in KERNELS]
        assert int(aux["raster_passes"]) == (6 if rig else 2)
        assert counts == ([9, 6, 3, 3] if rig else [2, 2, 1, 1])
        runs.append((state_tensors(st), aux["metrics"]["loss"]))
    (a, la), (b, lb) = runs
    assert torch.equal(la, lb)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
