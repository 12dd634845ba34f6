"""The span record (``s3gaussian_tpu_torch/utils/spans.py``) on the small
mid-training state of ``test_torch_cuda.py``.

On the CPU: a step's marks (the documented names, in the order of a
step, every camera of a rig marked, the cull and the all-reduce only
where they run), ``span_ns`` against the stamps, the decoder's inner
spans (``inner_ns``) inside their top-level spans and against their own
stamps, the feature pass marked only where the field has its head,
``field_rows`` and ``visible_rows`` against counts made from renders
outside a step, the rasterizer's passes and reused binnings, no
mark outside a step, the traced window's record, the host spans and
their nesting, and ``graphs.capture``'s times as its spans.  On the card
(``cuda``, skipped without one): a replayed block's spans against its
CUDA-event step times, the stamps' order, the ``span_mark`` kernels
of a profiler trace against the program's mark sequence, and a rig step
with the feature pass: 3 of 6 binnings reused, the marks unchanged, one
pair sort a camera.

The file imports neither jax nor the JAX package.
"""

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from s3gaussian_tpu_torch.render import renderer
from s3gaussian_tpu_torch.train import graphs
from s3gaussian_tpu_torch.train import trainer as tr
from s3gaussian_tpu_torch.utils import spans

from test_torch_cuda import _graph_cameras, _graph_setup
from torch_threads import one_torch_thread  # noqa: F401

PER_CAMERA = ("project.fwd", "bin.fwd", "composite.fwd", "composite.bwd",
              "bin.bwd", "project.bwd")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    state, args = _graph_setup(CPU)
    return state, args, _graph_cameras(CPU, 3)


def fresh(setup, cull=False):
    """A copy of the fixture's state and its step arguments (with the
    pre-deformation cull to a working set of 1,024 rows when ``cull``)."""
    state, args, cams = setup
    args = list(args)
    if cull:
        args[4] = dataclasses.replace(args[4], cull_before_deform=True,
                                      max_visible=1024)
    return graphs.clone_state(state), tuple(args), cams


def assert_marks(names, n_cams, cull, allreduce=False):
    """Every camera's stages once per camera, the others once, first seen
    in the order of ``spans.NAMES``."""
    once = {"field.fwd", "loss.fwd", "loss.bwd", "field.bwd", "update"}
    once |= {"cull"} if cull else set()
    once |= {"allreduce"} if allreduce else set()
    counts = {n: names.count(n) for n in set(names)}
    assert counts == {**{n: 1 for n in once},
                      **{n: n_cams for n in PER_CAMERA}}
    first = sorted(counts, key=names.index)
    assert first == [n for n in spans.NAMES if n in counts]


def assert_span_ns(aux, names):
    ns = aux["span_ns"]
    assert ns.shape == (len(spans.NAMES),) and ns.dtype == torch.int64
    assert bool((ns >= 0).all())
    stamps = spans.last_stamps()
    assert stamps.shape == (len(names) + 1,)
    assert int(ns.sum()) == int(stamps[-1] - stamps[0])
    assert {n for n, v in zip(spans.NAMES, ns.tolist()) if v > 0} \
        <= set(names)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("rig", [False, True])
def test_step_marks_every_stage(setup, rig, cull):
    """One eager step: the marks, ``span_ns`` and the field's rows, the
    last counted from a render of the same state outside a step."""
    state, args, cams = fresh(setup, cull)
    sh, hp, opt, pipe, cfg, _, bg = args
    view = cams if rig else cams[0]
    with torch.no_grad():
        if rig:
            pkg = renderer.render_multicam(cams, state.pool, state.deform,
                                           pipe, bg, state.aabb, sh,
                                           cfg=cfg)
        else:
            pkg = renderer.render(cams[0], state.pool, state.deform, pipe,
                                  bg, state.aabb, sh, cfg=cfg)
    visible = int(pkg["raster_aux"]["visible"].sum())
    step = tr.train_step_multicam if rig else tr.train_step
    _, aux = step(state, view, "fine", *args)
    names = spans.last_marks()
    assert_marks(names, len(cams) if rig else 1, cull)
    assert_span_ns(aux, names)
    assert int(aux["field_rows"]) == (1024 if cull else state.pool.capacity)
    assert 0 < int(aux["visible_rows"]) == visible
    # the fixture's cameras carry no feature map: no feature pass
    n_cams = len(cams) if rig else 1
    assert (int(aux["raster_passes"]), int(aux["bins_reused"])) == (
        n_cams, 0)
    # CPU tensors bin on the plain path: no key-emission kernel
    assert int(aux["bins_kernel"]) == 0
    assert set(spans.KEYS) <= set(tr.small_aux(aux))


def test_coarse_step_runs_no_field(setup):
    state, args, cams = fresh(setup)
    _, aux = tr.train_step(state, cams[0], "coarse", *args)
    names = spans.last_marks()
    assert "field.fwd" not in names and "field.bwd" not in names
    assert names[0] == "project.fwd" and names[-1] == "update"
    assert_span_ns(aux, names)
    assert int(aux["field_rows"]) == int(aux["visible_rows"]) == 0


def test_top_level_names_are_unchanged():
    """The inner spans add a counter and leave ``span_ns``'s names and
    order as the readers know them."""
    assert spans.NAMES == (
        "cull", "field.fwd", "project.fwd", "bin.fwd", "composite.fwd",
        "loss.fwd", "loss.bwd", "composite.bwd", "bin.bwd", "project.bwd",
        "field.bwd", "allreduce", "update")
    assert spans.INNER_NAMES == ("field.mlp.fwd", "field.mlp.bwd")
    assert spans.KEYS == ("span_ns", "inner_ns", "field_rows",
                          "visible_rows", "raster_passes", "bins_reused",
                          "bins_kernel")


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("rig", [False, True])
def test_inner_spans_lie_inside_their_spans(setup, rig, cull):
    """One stamp each: ``field.mlp.fwd`` from its own stamp to the stamp
    that opens ``project.fwd``, ``field.mlp.bwd`` from the stamp that
    opens ``field.bwd`` to its own; each within its top-level span."""
    state, args, cams = fresh(setup, cull)
    step = tr.train_step_multicam if rig else tr.train_step
    _, aux = step(state, cams if rig else cams[0], "fine", *args)
    names = spans.last_marks()
    assert spans.last_inner() == spans.INNER_NAMES
    inner = aux["inner_ns"]
    assert inner.shape == (len(spans.INNER_NAMES),)
    assert inner.dtype == torch.int64 and bool((inner > 0).all())
    top = dict(zip(spans.NAMES, aux["span_ns"].tolist()))
    mlp = dict(zip(spans.INNER_NAMES, inner.tolist()))
    assert mlp["field.mlp.fwd"] <= top["field.fwd"]
    assert mlp["field.mlp.bwd"] <= top["field.bwd"]
    stamps = spans.last_stamps()
    own = spans._stamp_buffer(CPU)[spans.MAX_MARKS:spans.MAX_MARKS + 2]
    assert mlp["field.mlp.fwd"] == int(
        stamps[names.index("project.fwd")] - own[0])
    assert mlp["field.mlp.bwd"] == int(
        own[1] - stamps[names.index("field.bwd")])
    # the top-level spans still tile the step
    assert_span_ns(aux, names)


def test_coarse_step_has_no_inner_span(setup):
    state, args, cams = fresh(setup)
    _, aux = tr.train_step(state, cams[0], "coarse", *args)
    assert spans.last_inner() == ()
    assert aux["inner_ns"].tolist() == [0] * len(spans.INNER_NAMES)


@pytest.mark.parametrize("feat_head", [True, False])
def test_feature_pass_marked_only_with_its_head(setup, feat_head):
    """A view with a feature map: with the DINO head each camera stage is
    marked twice (the RGB pass and the feature pass, which takes the RGB
    pass's binning), without it once, and the decoder's inner spans are
    there either way."""
    from s3gaussian_tpu_torch.data.cameras import make_camera
    from s3gaussian_tpu_torch.models.deformation import DeformationField

    state, args, cams = fresh(setup)
    sh, hp, opt, pipe, cfg, lr_scale, bg = args
    hp = dataclasses.replace(hp, feat_head=feat_head)
    state = tr.init_state(state.pool, DeformationField(
        hp, torch.Generator().manual_seed(0), CPU), state.aabb)
    c = cams[0]
    rng = np.random.default_rng(4)
    h, w = c.image_height, c.image_width
    cam = dataclasses.replace(c, feat_map=torch.from_numpy(
        rng.random((h, w, 3)).astype(np.float32)))
    _, aux = tr.train_step(state, cam, "fine", sh, hp, opt, pipe, cfg,
                           lr_scale, bg)
    names = spans.last_marks()
    passes = 2 if feat_head else 1
    assert {n: names.count(n) for n in PER_CAMERA} == dict.fromkeys(
        PER_CAMERA, passes)
    assert spans.last_inner() == spans.INNER_NAMES
    assert ("feat" in aux["metrics"]) is feat_head
    assert (int(aux["raster_passes"]), int(aux["bins_reused"])) == (
        passes, passes - 1)
    assert_span_ns(aux, names)


def test_allreduce_marked_in_the_data_parallel_step(setup, tmp_path):
    from s3gaussian_tpu_torch.parallel import data_parallel as dp
    from s3gaussian_tpu_torch.parallel.multihost import init_multihost

    state, args, cams = fresh(setup)
    assert init_multihost("file://" + str(tmp_path / "store"), 1, 0,
                          backend="gloo", device="cpu") == (0, 1)
    try:
        _, aux = dp.parallel_train_step(state, cams[0], "fine", *args)
    finally:
        torch.distributed.destroy_process_group()
    names = spans.last_marks()
    assert_marks(names, 1, False, allreduce=True)
    assert names[-2:] == ("allreduce", "update")
    assert_span_ns(aux, names)


def test_render_outside_a_step_marks_nothing(setup, monkeypatch):
    state, args, cams = fresh(setup)
    sh, hp, opt, pipe, cfg, _, bg = args
    made = []
    monkeypatch.setattr(spans.StepRecord, "mark",
                        lambda self, name: made.append(name))
    pool = state.pool.with_params({k: v.detach().requires_grad_(True)
                                   for k, v in
                                   state.pool.param_dict().items()})
    pkg = renderer.render(cams[0], pool, state.deform, pipe, bg, state.aabb,
                          sh, cfg=cfg)
    pkg["render"].sum().backward()
    assert pool.xyz.grad is not None and not made


def test_block_under_a_profiler_is_kept(setup):
    state, args, cams = fresh(setup)
    spans.reset()
    try:
        state, _ = tr.train_steps_scan(state, cams[:1], "fine", *args)
        assert spans.traced_steps() is None
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            state, aux = tr.train_steps_scan(state, cams[1:2], "fine", *args)
        kept = spans.traced_steps()
        state, _ = tr.train_steps_scan(state, cams[2:], "fine", *args)
        assert spans.traced_steps()["span_ns"].shape[0] == 1
    finally:
        spans.reset()
    assert kept["span_ns"].shape == (1, len(spans.NAMES))
    assert torch.equal(kept["span_ns"], aux["span_ns"])
    assert torch.equal(kept["inner_ns"], aux["inner_ns"])
    assert kept["field_rows"].tolist() == [state.pool.capacity]
    assert torch.equal(kept["visible_rows"], aux["visible_rows"].long())
    assert (kept["raster_passes"].tolist(), kept["bins_reused"].tolist()) \
        == ([1], [0])


def test_host_spans_nest_with_their_parent():
    from s3gaussian_tpu_torch.models.pool import create_from_pcd
    from s3gaussian_tpu_torch.train_cli import auto_max_visible

    spans.reset()
    try:
        with spans.host("outer") as outer:
            with spans.host("inner") as inner:
                time.sleep(0.002)
        rng = np.random.default_rng(0)
        pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
        pool = create_from_pcd(pts, rng.random((200, 3)), 256, device=CPU)
        auto_max_visible(pts, _graph_cameras(CPU, 2), pool.capacity)
        ended = spans.host_spans()
        line = spans.host_line()
    finally:
        spans.reset()
    assert [(s.name, s.parent) for s in ended] == [
        ("outer", None), ("inner", "outer"), ("pool.init", None),
        ("pool.knn", "pool.init"), ("budget", None)]
    assert (outer.start_ns <= inner.start_ns < inner.end_ns
            <= outer.end_ns)
    assert inner.ms >= 2.0
    assert line == "host spans (s): " + ", ".join(
        f"{s.name} {s.ms / 1e3:.3f}" for s in ended)


def test_capture_times_are_its_spans(monkeypatch):
    """``graphs.capture``'s warm-up and capture ms are the ``graph.warmup``
    and ``graph.capture`` spans (the card's stream and graph calls
    replaced by no-ops)."""

    class Stream:
        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass

    def nothing(*args, **kw):
        return contextlib.nullcontext()

    monkeypatch.setattr(graphs, "side_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "stream", nothing)
    monkeypatch.setattr(torch.cuda, "graph", nothing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    spans.reset()
    try:
        _, out, warm_ms, cap_ms, _ = graphs.capture(
            CPU, lambda: time.sleep(0.003),
            lambda: time.sleep(0.006) or "out")
        warm, = spans.host_spans("graph.warmup")
        cap, = spans.host_spans("graph.capture")
    finally:
        spans.reset()
    assert out == "out"
    assert (warm_ms, cap_ms) == (warm.ms, cap.ms)
    assert warm_ms >= 3.0 and cap_ms >= 6.0 and cap.start_ns >= warm.end_ns


def test_step_line():
    ns = torch.zeros(len(spans.NAMES), dtype=torch.int64)
    ns[spans.NAMES.index("field.fwd")] = 2_500_000
    ns[spans.NAMES.index("update")] = 1_000
    line = spans.step_line({"span_ns": ns, "field_rows": torch.tensor(400),
                            "visible_rows": torch.tensor(100)})
    assert line == ("spans (ms): field.fwd 2.500, update 0.001; visible "
                    "rows / field rows 100 / 400 (25.00%)")
    inner = torch.tensor([1_250_000, 0])
    line = spans.step_line({"span_ns": ns, "inner_ns": inner,
                            "field_rows": torch.tensor(400),
                            "visible_rows": torch.tensor(100)})
    assert line == ("spans (ms): field.fwd 2.500, update 0.001; inside them "
                    "field.mlp.fwd 1.250; visible rows / field rows 100 / "
                    "400 (25.00%)")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replayed():
    """A captured rig step on the card and the cameras of its blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span mark is a CUDA kernel")
    dev = torch.device("cuda")
    state, args = _graph_setup(dev, seed=15)
    cams = _graph_cameras(dev, 15, seed=25)
    rigs = [cams[3 * i:3 * i + 3] for i in range(5)]
    graphs.release()
    state, _ = tr.train_steps_scan_multicam(state, rigs[:1], 3, "fine",
                                            *args)
    torch.cuda.synchronize()
    yield state, args, rigs
    graphs.release()


@pytest.mark.cuda
def test_cuda_block_spans_cover_its_steps(replayed):
    """A block of 5 replays: the steps' spans sum to within 5% of their
    CUDA-event time less the host's gap before the first replay, a gap
    shorter than a step; the stamps of the last never decrease, and one
    step's spans sum to its last stamp less its first."""
    state, args, rigs = replayed
    marks = []
    state, aux = tr.train_steps_scan_multicam(state, rigs, 3, "fine", *args,
                                              marks=marks)
    torch.cuda.synchronize()
    event = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    span = (aux["span_ns"].sum(1).double() / 1e6).tolist()
    outside = [e - s for e, s in zip(event, span)]
    # the first interval also holds the card idling while the host issues
    # the first replay; after it the host runs ahead of the card, so each
    # later interval holds only the step's device work (its spans and its
    # input and output copies)
    gap = outside[0] - max(outside[1:])
    assert gap < min(event[1:]), (gap, event, span)
    busy = sum(event) - max(gap, 0.0)
    assert abs(sum(span) - busy) <= 0.05 * busy, (event, span)
    stamps = spans.last_stamps().cpu()
    assert bool((stamps[1:] >= stamps[:-1]).all())
    assert int(aux["span_ns"][-1].sum()) == int(stamps[-1] - stamps[0])
    assert_marks(spans.last_marks(), 3, False)
    field = aux["span_ns"][:, [spans.NAMES.index("field.fwd"),
                               spans.NAMES.index("field.bwd")]]
    assert bool((aux["inner_ns"] > 0).all())
    assert bool((aux["inner_ns"] <= field).all())


@pytest.mark.cuda
def test_cuda_trace_holds_every_mark(replayed):
    """A profiler trace of a replayed block of 3 holds exactly (marks a
    step, the inner ones included, × steps) ``span_mark`` kernels, as
    many as the launch count says, and the block is kept."""
    from s3gaussian_tpu_torch.ops import tile_kernels as tk

    state, args, rigs = replayed
    spans.reset()
    before = tk.launches["span_mark"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            state, _ = tr.train_steps_scan_multicam(state, rigs[:3], 3,
                                                    "fine", *args)
            torch.cuda.synchronize()
        kept = spans.traced_steps()
    finally:
        spans.reset()
    n = sum(e.count for e in prof.key_averages() if e.key == "span_mark")
    marks = len(spans.last_marks()) + 1 + len(spans.last_inner())
    assert n == 3 * marks
    assert tk.launches["span_mark"] - before == n
    assert kept["span_ns"].shape == (3, len(spans.NAMES))


def _profiled_replay(state, args, rigs):
    """One replay of the rig step, captured anew on the first rig, under
    the profiler: (device kernels by name, its aux, the step's marks and
    inner marks)."""
    graphs.release()
    state, _ = tr.train_steps_scan_multicam(graphs.clone_state(state),
                                            rigs[:1], 3, "fine", *args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, aux = tr.train_steps_scan_multicam(state, rigs[1:], 3, "fine",
                                              *args)
        torch.cuda.synchronize()
    graphs.release()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0) + 1
    return kernels, aux, spans.last_marks(), spans.last_inner()


@pytest.mark.cuda
def test_cuda_feature_pass_takes_its_camera_binning(monkeypatch):
    """A captured rig step of 3 cameras with the feature head: 3 of its 6
    rasterize calls reuse a binning; it makes the marks the step makes
    when each feature pass bins itself, one ``span_mark`` kernel each;
    and a replay runs the sort kernels of the same rig without a feature
    pass (one pair sort a camera, half the 6 compositor passes), three
    pair sorts fewer than a replay whose feature passes bin
    themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span mark is a CUDA kernel")
    from s3gaussian_tpu_torch.render import renderer

    dev = torch.device("cuda")
    state, args = _graph_setup(dev, seed=15)
    rng = np.random.default_rng(6)
    cams = [dataclasses.replace(c, feat_map=torch.from_numpy(
        rng.random((c.image_height, c.image_width, 3)).astype(np.float32)
    ).to(dev)) for c in _graph_cameras(dev, 6, seed=25)]
    rigs = [cams[:3], cams[3:]]
    spans.reset()
    try:
        shared = _profiled_replay(state, args, rigs)
        real = renderer.rasterize
        with monkeypatch.context() as m:
            m.setattr(renderer, "rasterize",
                      lambda *a, binning=None, **kw: real(*a, **kw))
            own = _profiled_replay(state, args, rigs)
        plain = _profiled_replay(state, args, [
            [dataclasses.replace(c, feat_map=None) for c in r]
            for r in rigs])
    finally:
        spans.reset()
    kernels, aux, names, inner = shared
    assert (aux["raster_passes"].tolist(), aux["bins_reused"].tolist()) \
        == ([6], [3])
    assert (own[1]["raster_passes"].tolist(),
            own[1]["bins_reused"].tolist()) == ([6], [0])
    assert "feat" in aux["metrics"] and "feat" not in plain[1]["metrics"]
    assert_marks(names, 6, False)
    assert (names, inner) == own[2:]
    assert kernels["span_mark"] == len(names) + 1 + len(inner) \
        == own[0]["span_mark"]

    def count(table, pick):
        return sum(n for name, n in table.items() if pick(name))

    def sorts(table):
        return count(table, lambda name: "sort" in name.lower())

    got = (sorts(kernels), sorts(plain[0]), sorts(own[0]))
    assert count(kernels, lambda n: "composite_fwd_kernel" in n) == 6
    assert got[0] == got[1] < got[2], got
    assert (got[2] - got[0]) % 3 == 0, got
