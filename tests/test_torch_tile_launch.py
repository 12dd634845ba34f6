"""The launch geometry of the CUDA compositors
(``s3gaussian_tpu_torch/ops/tile_kernels.py::launch_geometry`` and
``pixel_slots``, the map of ``csrc/composite_common.cuh::pixel_slot``).

It is plain Python, so it is checked here on the CPU for every tile from
4x4 to 32x32: whole warps, every pixel owned by exactly one (thread,
slot), shared memory within an H100 block's 232,448 bytes, and a raise
for what the kernels cannot serve.
"""

import pytest
import torch

from s3gaussian_tpu_torch.ops import tile_kernels as tk


@pytest.mark.parametrize("tx", range(4, 33))
def test_geometry_covers_every_tile(tx):
    ppt, batch = tk.PIXELS_PER_THREAD, tk.BATCH
    for ty in range(4, 33):
        g = tk.launch_geometry(tx, ty)
        columns = tx * -(-ty // ppt)
        assert (g.pixels_per_thread, g.batch) == (ppt, batch)
        assert g.threads % 32 == 0 and 0 < g.threads <= 1024
        assert g.threads >= columns > g.threads - 32
        stages = 2 * 10 * batch * 4          # two ring stages of the batch
        partials = (g.threads // 32) * batch * 11 * 4
        assert g.fwd_smem_bytes == stages
        assert g.bwd_smem_bytes == stages + partials <= 232_448

        slots = tk.pixel_slots(g, tx, ty)
        assert slots.shape == (g.threads, ppt)
        owned = slots[slots >= 0]
        assert torch.equal(torch.sort(owned).values, torch.arange(tx * ty))
        # a thread's pixels: one column, consecutive rows, in slot order,
        # the owned slots first
        valid = slots >= 0
        assert bool((valid[:, 1:] <= valid[:, :-1]).all())
        first = slots[:, :1]
        step = torch.arange(ppt)[None, :]
        assert bool(((slots % tx == first % tx) | ~valid).all())
        assert bool(((slots // tx == first // tx + step) | ~valid).all())


def test_geometry_of_the_headline_tile():
    """16x16 tiles: 128 threads of 2 pixels, each warp a 16x4 block."""
    g = tk.launch_geometry(16, 16)
    assert (g.pixels_per_thread, g.threads, g.batch) == (2, 128, 128)
    assert (g.fwd_smem_bytes, g.bwd_smem_bytes) == (10_240, 32_768)
    slots = tk.pixel_slots(g, 16, 16)
    for w in range(4):
        pix = slots[32 * w:32 * (w + 1)].flatten()
        assert sorted((pix // 16).unique().tolist()) == list(
            range(4 * w, 4 * w + 4))
        assert sorted((pix % 16).unique().tolist()) == list(range(16))


# over 1024 pixels, or none; 1024x1: a thread owns pixels of one column, so
# a tile one row high needs a thread per pixel, more than the kernels' 512
@pytest.mark.parametrize("tile", [(33, 32), (48, 48), (64, 17), (1025, 1),
                                  (0, 16), (16, 0), (1024, 1)])
def test_geometry_raises_on_a_tile_the_kernels_cannot_serve(tile):
    with pytest.raises(ValueError):
        tk.launch_geometry(*tile)


@pytest.fixture
def zeroed_counts(monkeypatch):
    """Both count tables of ``tile_kernels`` at 0, restored afterwards."""
    for table in (tk.launches, tk.captured):
        for kernel in tk.KERNELS:
            monkeypatch.setitem(table, kernel, 0)


@pytest.mark.parametrize("capturing", [False, True],
                         ids=["eager", "capturing"])
def test_launches_are_counted_by_kernel(monkeypatch, zeroed_counts,
                                        capturing):
    """A launch counts under its kernel's name: in ``captured`` while the
    stream captures a graph, else in ``launches``."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    for kernel in ("composite_fwd", "hexplane_bwd", "hexplane_bwd"):
        tk._count(kernel)
    counted, other = ((tk.captured, tk.launches) if capturing
                      else (tk.launches, tk.captured))
    assert counted == {**dict.fromkeys(tk.KERNELS, 0), "composite_fwd": 1,
                       "hexplane_bwd": 2}
    assert not any(other.values())
    assert tk.compositor_launches(counted) == (1, 0)
    with pytest.raises(KeyError):
        tk._count("no_such_kernel")


def test_replays_add_what_their_graph_captured(zeroed_counts):
    graph = {"composite_fwd": 3, "composite_bwd": 3, "span_mark": 12,
             "hexplane_fwd": 1, "hexplane_bwd": 4, "project_fwd": 9,
             "project_bwd": 6, "sh_fwd": 3, "sh_bwd": 3, "bin_keys": 3}
    for _ in range(2):
        tk.count_replay(graph)
    assert tk.launches == {**{k: 2 * n for k, n in graph.items()},
                           "segment_sum": 0}
    assert tk.compositor_launches() == (6, 6)
    tk.reset("composite_fwd", "composite_bwd")
    assert tk.compositor_launches() == (0, 0)
    assert tk.launches["hexplane_bwd"] == 8
    tk.reset()
    assert not any(tk.launches.values())
