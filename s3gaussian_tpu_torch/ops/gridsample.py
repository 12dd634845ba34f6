"""Bilinear/trilinear grid sampling, align_corners=True with border
padding (port of ``s3gaussian_tpu/ops/gridsample.py``).

Written as explicit corner gathers and lerps rather than
``F.grid_sample`` so that a ``compute_dtype`` grid (bfloat16 plane
values) is sampled the way the JAX package samples it: the gathered
values keep the grid's dtype while coordinates and interpolation weights
stay float32, and the lerp promotes to float32.

Gradients are autograd, except where the grid's gradient sums the
gradients of many gathered rows into one.  Those sums run in a fixed
order, with no atomics, so a step gives the same bits each time:
``segment_sum`` sorts the row indices once (stably) and adds each row's
gradients in that order, in float32 (on the card through the CUDA kernel
of ``ops/segsum.py``).

  * the spatial planes and ``grid_sample_3d`` (``gather_rows``): the
    corners' gradients summed in float32 and rounded once to the grid's
    dtype (JAX's autodiff of the gathers sums in the grid's dtype; plain
    autograd would sum tens of thousands of bfloat16 products per cell in
    bfloat16);
  * the time planes (``sample_time_plane``): JAX's hand-written VJP of
    ``_sample_rows_1d`` (``gridsample.py:117-160``) over the paired rows
    ``[W, 2C]``: the products cast to the grid's dtype, summed per row in
    float32, rounded once; the position's gradient the float32 channel
    sum of ``(hi - lo)·g``.  The two time rows the lerp reads are taken
    by ``_TimeRows``, whose backward writes each row once.

On the card the hexplane's per-point work (``hexplane_query``: every
scale's six samples and their product, and its backward) runs in the
CUDA kernels of ``csrc/hexplane.cu``, bit for bit the plain version's
arithmetic, and its grid gradients go through the same ``segment_sum``
with the same keys and values; only CPU tensors take the plain version
(``models/hexplane.py::query_hexplane`` over ``grid_sample_2d`` and
``sample_time_plane``).
"""

from __future__ import annotations

import ctypes

import torch

from s3gaussian_tpu_torch.ops import tile_kernels as tk
from s3gaussian_tpu_torch.ops.segsum import sum_ranges

# rows one sum of ``segment_sum`` reads in sequence, at each level
PIECE = 32


def segment_sum(keys: torch.Tensor, vals: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """``out[r] = Σ vals[i] over keys[i] == r`` -> [n_rows, D] float32, in
    a fixed order and with no atomics.  keys [K] int32 or int64 in [0,
    n_rows); vals [K, D].

    The keys are sorted once (stably); each segment of the sorted rows is
    then summed in levels (``ops/segsum.py::sum_ranges``, the first
    reading the rows through the sort's permutation): every level cuts
    the rows at the segment starts and every PIECE rows and sums each
    piece in sequence, until a segment spans at most PIECE pieces, which
    the last sum adds."""
    dev = keys.device
    key_dtype = torch.int32 if n_rows < 2 ** 31 else torch.int64
    sk, perm = torch.sort(keys.to(key_dtype), stable=True)
    offs = torch.searchsorted(
        sk, torch.arange(n_rows + 1, dtype=key_dtype, device=dev))
    data = vals.to(torch.float32).contiguous()
    n = span = keys.shape[0]      # span: the most rows a segment spans
    while span > PIECE:
        data, offs, n = _level(data, perm, offs, n)
        perm = None
        span = -(-span // PIECE) + 1
    return sum_ranges(data, perm, offs)


def _level(data: torch.Tensor, perm, offs: torch.Tensor, n: int):
    """One level: the n rows cut at every segment offset and every PIECE
    rows, so that no piece is empty, and each piece summed.  Returns the
    piece sums [bound, D] (zeros past the last piece), each segment's
    offset into them [R+1], and the static bound on the pieces."""
    dev = offs.device
    pos = torch.arange(n, device=dev)
    at = torch.clamp(torch.searchsorted(offs, pos), max=offs.shape[0] - 1)
    piece = torch.cumsum((offs[at] == pos) | (pos % PIECE == 0), 0) - 1
    bound = min(offs.shape[0], n) + -(-n // PIECE)
    sums = sum_ranges(data, perm, torch.searchsorted(
        piece, torch.arange(bound + 1, device=dev)))
    return sums, torch.where(offs < n, piece[torch.clamp(offs, max=n - 1)],
                             piece[-1:] + 1), bound


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` for each index tensor; the table's gradient from
    all of them is ``segment_sum``'s, rounded once to its dtype."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, *idxs: torch.Tensor):
        ctx.save_for_backward(*idxs)
        ctx.shape = table.shape
        ctx.dtype = table.dtype
        return tuple(table[idx] for idx in idxs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        acc = segment_sum(torch.cat(ctx.saved_tensors),
                          torch.cat(grads), ctx.shape[0])
        return (acc.reshape(ctx.shape).to(ctx.dtype),) + (None,) * len(grads)


def gather_rows(table: torch.Tensor, *idxs: torch.Tensor):
    """table [R, C], each idx [K] int64 -> a tuple of table[idx] [K, C]."""
    return _GatherRows.apply(table, *idxs)


def _axis(v: torch.Tensor, n: int):
    """Normalized coordinate -> (low index, high index, weight [N,1])."""
    u = torch.clamp((v + 1.0) * 0.5 * (n - 1), 0.0, n - 1)
    u0 = torch.floor(u)
    i0 = u0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n - 1), (u - u0)[:, None]


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, H, W]; coords [N, 2] in [-1, 1], (x -> W, y -> H) as in
    torch's grid_sample.  Returns [N, C]."""
    c, h, w = grid.shape
    x0, x1, wx = _axis(coords[:, 0], w)
    y0, y1, wy = _axis(coords[:, 1], h)
    rows = grid.reshape(c, h * w).t()                   # [H*W, C]
    v00, v01, v10, v11 = gather_rows(rows, y0 * w + x0, y0 * w + x1,
                                     y1 * w + x0, y1 * w + x1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, D, H, W]; coords [N, 3] in [-1, 1], (x -> W, y -> H,
    z -> D).  Returns [N, C]."""
    c, d, h, w = grid.shape
    x0, x1, wx = _axis(coords[:, 0], w)
    y0, y1, wy = _axis(coords[:, 1], h)
    z0, z1, wz = _axis(coords[:, 2], d)
    flat = grid.reshape(c, -1).t()                      # [D*H*W, C]

    v = gather_rows(flat, *((z * h + y) * w + x for z in (z0, z1)
                            for y in (y0, y1) for x in (x0, x1)))

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(v[0], v[1], wx)
    c01 = lerp(v[2], v[3], wx)
    c10 = lerp(v[4], v[5], wx)
    c11 = lerp(v[6], v[7], wx)
    return lerp(lerp(c00, c01, wy), lerp(c10, c11, wy), wz)


class _TimeRows(torch.autograd.Function):
    """Rows ``y0`` and ``y0 + 1`` of a plane [C, Ht, W] at a 0-d index
    tensor (JAX's ``dynamic_slice``); the backward writes each row's
    gradient once, where ``index_select``'s would add it with atomics."""

    @staticmethod
    def forward(ctx, plane: torch.Tensor, y0: torch.Tensor):
        rows = plane.index_select(1, torch.stack([y0, y0 + 1]))
        ctx.save_for_backward(y0)
        ctx.h = plane.shape[1]
        return rows[:, 0, :], rows[:, 1, :]

    @staticmethod
    def backward(ctx, d0: torch.Tensor, d1: torch.Tensor):
        (y0,) = ctx.saved_tensors
        row = torch.arange(ctx.h, device=y0.device)[None, :, None]
        zero = torch.zeros((), dtype=d0.dtype, device=d0.device)
        return torch.where(row == y0, d0[:, None, :], torch.where(
            row == y0 + 1, d1[:, None, :], zero)), None


class _SampleRows1d(torch.autograd.Function):
    """JAX's ``_sample_rows_1d``: rows2 [W, 2C] of (v_x, v_{x+1}) pairs
    lerped at x [N] (pixel units, clipped to [0, W-1]) -> [N, C]."""

    @staticmethod
    def forward(ctx, rows2: torch.Tensor, x: torch.Tensor):
        c = rows2.shape[1] // 2
        x0 = torch.floor(x)
        # the weights stay float32; the lerp promotes the gathered values
        wx = (x - x0)[:, None]
        x0i = x0.to(torch.int64)
        r = rows2[x0i]                                  # [N, 2C] one gather
        ctx.save_for_backward(r, x0i, wx)
        ctx.w = rows2.shape[0]
        return (1 - wx) * r[:, :c] + wx * r[:, c:]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        r, x0i, wx = ctx.saved_tensors
        c = r.shape[1] // 2
        d_x = ((r[:, c:] - r[:, :c]) * g).to(torch.float32).sum(1)
        # the products in the grid's dtype, summed per row in float32,
        # rounded once
        d_pairs = torch.cat([(1 - wx) * g, wx * g], 1).to(r.dtype)
        d_rows2 = segment_sum(x0i, d_pairs, ctx.w).to(r.dtype)
        return d_rows2, d_x


def time_pair_rows(plane: torch.Tensor,
                   t_scalar: torch.Tensor) -> torch.Tensor:
    """A time plane [C, Ht, W] folded at the 0-d ``t_scalar`` into its
    edge-padded pair rows [W, 2C]: row x holds (v_x, v_{x+1}) of the
    t-lerped row, computed in the plane's dtype, as in JAX."""
    c, h, w = plane.shape
    if h == 1:
        sig = plane[:, 0, :]
    else:
        y = torch.clamp((t_scalar + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
        y0 = torch.clamp(torch.floor(y), 0.0, h - 2)
        wy = (y - y0).to(plane.dtype)
        r0, r1 = _TimeRows.apply(plane, y0.to(torch.int64).reshape(()))
        sig = (1 - wy) * r0 + wy * r1                   # [C, W]
    return torch.cat([sig, torch.cat([sig[:, 1:], sig[:, -1:]], 1)],
                     0).t().contiguous()


def sample_time_plane(plane: torch.Tensor, sx: torch.Tensor,
                      t_scalar: torch.Tensor) -> torch.Tensor:
    """== grid_sample_2d(plane, stack([sx, t], 1)) for one scalar t.

    plane [C, Ht, W] (time on the row axis); sx [N] in [-1, 1]; t_scalar a
    0-d tensor in [-1, 1].  The t-lerp folds into one [C, W] row before
    the per-point work (``time_pair_rows``); its pairs [W, 2C] are the
    rows each point gathers once."""
    w = plane.shape[2]
    rows2 = time_pair_rows(plane, t_scalar)
    x = torch.clamp((sx + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    return _SampleRows1d.apply(rows2, x)


# --- the hexplane query in the CUDA kernels of csrc/hexplane.cu

# a scale's six planes pair the coordinates as models/hexplane.py's
# COO_COMBS; these three pair one with time
HEX_TIME_PLANES = (2, 4, 5)
HEX_MAX_SCALES = 8
HEX_MAX_CHANNELS = 32     # a lane a channel
HEX_DTYPES = (torch.bfloat16, torch.float32)


def check_hexplane(x: torch.Tensor, t: torch.Tensor, planes) -> None:
    """Raises (ValueError, TypeError) on what ``hexplane_query`` does not
    take: x [N, 3] float32; t a 0-d tensor (one time for every row); the
    planes [C, H, W], six a scale in ``COO_COMBS`` order, at most
    HEX_MAX_SCALES scales, one dtype of HEX_DTYPES, one channel count C of
    1 to HEX_MAX_CHANNELS, all on x's device."""
    if t.dim() != 0:
        raise ValueError(f"the hexplane kernels take one time for every row "
                         f"(a 0-d t), got t of shape {tuple(t.shape)}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if t.device != x.device:
        raise ValueError(f"t on {t.device}, x on {x.device}")
    if not planes or len(planes) % 6 or len(planes) > 6 * HEX_MAX_SCALES:
        raise ValueError(f"{len(planes)} planes: six a scale, 1 to "
                         f"{HEX_MAX_SCALES} scales")
    dtype, c = planes[0].dtype, planes[0].shape[0]
    if dtype not in HEX_DTYPES:
        raise TypeError(f"the planes must be bfloat16 or float32, got "
                        f"{dtype}")
    if not 1 <= c <= HEX_MAX_CHANNELS:
        raise ValueError(f"{c} channels: the kernels take 1 to "
                         f"{HEX_MAX_CHANNELS}")
    for i, p in enumerate(planes):
        if p.dim() != 3 or p.shape[0] != c or p.numel() == 0:
            raise ValueError(f"plane {i} must be [{c}, H, W], got "
                             f"{tuple(p.shape)}")
        if p.shape[1] * p.shape[2] >= 2 ** 31:
            raise ValueError(f"plane {i} has {p.shape[1] * p.shape[2]} "
                             f"cells, beyond the kernels' int32 keys")
        if p.dtype != dtype:
            raise TypeError(f"plane {i} is {p.dtype}, plane 0 {dtype}")
        if p.device != x.device:
            raise ValueError(f"plane {i} on {p.device}, x on {x.device}")


def _hex_args(planes):
    """The kernels' arguments for the planes of ``hexplane_layout``
    (spatial [H, W, C], time pair rows [W, 2C]): pointers, (h, w) each (h
    1 for a time plane), and whether they are bfloat16."""
    ptrs = (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))
    dims = []
    for i, p in enumerate(planes):
        dims += ([1, p.shape[0]] if i % 6 in HEX_TIME_PLANES
                 else [p.shape[0], p.shape[1]])
    return (ptrs, (ctypes.c_int * len(dims))(*dims),
            int(planes[0].dtype == torch.bfloat16))


def hexplane_fwd(x: torch.Tensor, planes) -> torch.Tensor:
    """Launch the forward kernel: x [N, 3] float32 (normalised), the
    laid-out planes of ``hexplane_query`` -> [N, C·S] float32."""
    n, s, c = x.shape[0], len(planes) // 6, planes[0].shape[-1]
    out = torch.empty((n, c * s), dtype=torch.float32, device=x.device)
    ptrs, dims, bf16 = _hex_args(planes)
    lib = tk._load("hexplane")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hexplane_fwd(x.data_ptr(), n, s, c, bf16, ptrs, dims,
                               out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hexplane_fwd kernel launch failed: CUDA error "
                           f"{err}")
    tk._count("hexplane_fwd")
    return out


def hexplane_bwd(x: torch.Tensor, planes, g: torch.Tensor, scale: int,
                 dx: torch.Tensor, accumulate: bool):
    """Launch the backward kernel of scale ``scale`` over its six laid-out
    planes, g [N, C·S] the features' cotangent: writes (or adds to) dx
    [N, 3] and returns, a plane each in order, a spatial plane's (keys
    [4N] int32, corner cotangents [4N, C] float32, corner-major) or a time
    plane's (keys [N] int32, pair cotangents [N, 2C] float32)."""
    n, c, dev = x.shape[0], planes[0].shape[-1], x.device
    outs = []
    for i in range(6):
        rows, cols = (n, 2 * c) if i in HEX_TIME_PLANES else (4 * n, c)
        outs.append((torch.empty(rows, dtype=torch.int32, device=dev),
                     torch.empty((rows, cols), dtype=torch.float32,
                                 device=dev)))
    spatial = [o for i, o in enumerate(outs) if i not in HEX_TIME_PLANES]
    time = [outs[i] for i in HEX_TIME_PLANES]
    # corner values, corner keys, pair values, pair keys
    order = ([v for _, v in spatial] + [k for k, _ in spatial]
             + [v for _, v in time] + [k for k, _ in time])
    out_ptrs = (ctypes.c_void_p * 12)(*(o.data_ptr() for o in order))
    ptrs, dims, bf16 = _hex_args(planes)
    lib = tk._load("hexplane")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hexplane_bwd(x.data_ptr(), n, c, bf16, ptrs, dims,
                               g.data_ptr(), g.shape[1], scale * c, out_ptrs,
                               dx.data_ptr(), int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"hexplane_bwd kernel launch failed: CUDA error "
                           f"{err}")
    tk._count("hexplane_bwd")
    return outs


class _HexplaneQuery(torch.autograd.Function):
    """``hexplane_fwd`` with one ``hexplane_bwd`` a scale as its backward;
    each plane's cotangents summed by ``segment_sum`` and rounded once to
    its dtype, as ``_GatherRows`` and ``_SampleRows1d`` do.  Saves only
    its inputs: the backward recomputes the samples."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, *planes: torch.Tensor):
        ctx.save_for_backward(x, *planes)
        return hexplane_fwd(x, planes)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, *planes = ctx.saved_tensors
        g = g.contiguous()
        dx = torch.empty_like(x)
        grads = []
        for s in range(len(planes) // 6):
            scale = planes[6 * s:6 * s + 6]
            outs = hexplane_bwd(x, scale, g, s, dx, s > 0)
            for i, p in enumerate(scale):
                keys, vals = outs[i]
                outs[i] = None          # each plane's cotangents freed
                if not ctx.needs_input_grad[1 + 6 * s + i]:
                    grads.append(None)
                    continue
                rows = (p.shape[0] if i in HEX_TIME_PLANES
                        else p.shape[0] * p.shape[1])
                grads.append(segment_sum(keys, vals, rows).to(p.dtype)
                             .reshape(p.shape))
                del keys, vals
        return (dx if ctx.needs_input_grad[0] else None, *grads)


def hexplane_query(x: torch.Tensor, t: torch.Tensor, planes) -> torch.Tensor:
    """The hexplane's features on the card: x [N, 3] float32 (coordinates
    normalised by the aabb), t a 0-d tensor, planes [C, H, W] six a scale
    in ``COO_COMBS`` order, in the grid's compute dtype -> [N, C·S]
    float32, the plain version's bits (``check_hexplane`` says what it
    takes).  Under autograd, once a call, the planes are laid out as the
    kernels read them (``hexplane_layout``)."""
    check_hexplane(x, t, planes)
    if x.device.type != "cuda":
        raise ValueError(f"the hexplane kernels run on CUDA tensors, not "
                         f"{x.device}: the plain version is "
                         f"models/hexplane.py::query_hexplane")
    return _HexplaneQuery.apply(x.contiguous(), *hexplane_layout(planes, t))


def hexplane_layout(planes, t: torch.Tensor):
    """The planes [C, H, W] (six a scale in ``COO_COMBS`` order) as the
    kernels read them: a spatial plane copied channel-last [H, W, C], a
    time plane folded at the 0-d ``t`` into its pair rows [W, 2C]
    (``time_pair_rows``)."""
    return [time_pair_rows(p, t) if i % 6 in HEX_TIME_PLANES
            else p.permute(1, 2, 0).contiguous()
            for i, p in enumerate(planes)]
