# Frozen copy of s3gaussian_tpu_torch/ops/composite.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Tile compositing helpers and the plain PyTorch compositors, forward and
backward (port of ``s3gaussian_tpu/ops/composite.py``).

``composite_tiles_torch`` and ``composite_tiles_bwd_torch`` are the plain
versions of the CUDA kernels in ``csrc/composite_fwd.cu`` and
``csrc/composite_bwd.cu``: the CPU path and the kernels' oracles.  They
follow the Pallas kernels' semantics, not the jnp oracle's: every pair
of a tile is composited (the jnp oracle stops at ``max_pairs_per_tile``).

Per tile, pairs are taken in chunks of C; within a chunk the sequential
transmittance recursion ``T *= (1-α)`` is an inclusive ``cumprod`` along
the chunk axis, so every pair's weight ``w = α·T`` is data parallel.  A
pair contributes while the transmittance after it stays >= 1e-4 — the
CUDA reference's per-pixel ``done`` flag, stateless because T is
monotone.  ``final_T`` is ``1 - Σw``.
"""

from __future__ import annotations

import torch

PAIR_FEAT_DIM = 16
# feature row layout of the [16, M] pair stream (row FONE is constant 1)
FX, FY, FCA, FCB, FCC, FOP, FR, FG, FB, FD = range(10)
FONE = 10
N_DATA_ROWS = FD + 1
N_OUT_ROWS = 8  # 0-2 rgb, 3 depth, 4 final_T, 5 n_contrib, 6-7 zero

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def pack_pool_features(xy: torch.Tensor, conic: torch.Tensor,
                       opacity: torch.Tensor, color: torch.Tensor,
                       depth: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian screen quantities -> [16, N] feature rows."""
    n = xy.shape[0]
    rows = [xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
            opacity.reshape(n), color[:, 0], color[:, 1], color[:, 2],
            depth.reshape(n), torch.ones_like(xy[:, 0])]
    rows += [torch.zeros_like(xy[:, 0])] * (PAIR_FEAT_DIM - len(rows))
    return torch.stack(rows, 0)


def tile_pixel_coords(grid_x: int, grid_y: int, tile_x: int, tile_y: int,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinates [T, 1, P] of every tile (row-major tiles
    and pixels), as float32."""
    lane = torch.arange(tile_x * tile_y, device=device)
    tile = torch.arange(grid_x * grid_y, device=device)[:, None]
    px = (tile % grid_x) * tile_x + lane % tile_x
    py = (tile // grid_x) * tile_y + lane // tile_x
    return px[:, None].to(torch.float32), py[:, None].to(torch.float32)


def composite_tiles_torch(pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                          grid_x: int, grid_y: int, tile_x: int, tile_y: int,
                          chunk: int = 128) -> torch.Tensor:
    """Forward compositing of the sorted [16, M] pair stream, vectorised
    over tiles.  tile_starts [T+1].  Returns [T, 8, P]."""
    dev = pair_feat.device
    n_tiles = grid_x * grid_y
    p = tile_x * tile_y
    starts = tile_starts[:-1].to(torch.int64)
    counts = tile_starts[1:].to(torch.int64) - starts
    px, py = tile_pixel_coords(grid_x, grid_y, tile_x, tile_y, dev)

    acc = torch.zeros(n_tiles, 5, p, device=dev)
    nc = torch.zeros(n_tiles, p, device=dev)
    t = torch.ones(n_tiles, 1, p, device=dev)
    lane = torch.arange(chunk, device=dev)
    n_chunks = -(-int(counts.max()) // chunk) if n_tiles else 0
    for ci in range(n_chunks):
        valid = (ci * chunk + lane)[None, :] < counts[:, None]      # [T,C]
        idx = torch.where(valid, starts[:, None] + ci * chunk + lane, 0)
        f = pair_feat[:, idx]                                       # [16,T,C]
        dx = f[FX][..., None] - px                                  # [T,C,P]
        dy = f[FY][..., None] - py
        power = (-0.5 * (f[FCA][..., None] * dx * dx
                         + f[FCC][..., None] * dy * dy)
                 - f[FCB][..., None] * dx * dy)
        alpha = torch.clamp(f[FOP][..., None] * torch.exp(power),
                            max=ALPHA_MAX)
        am = torch.where((power > 0) | (alpha < ALPHA_MIN)
                         | ~valid[..., None], 0.0, alpha)
        one_m = 1.0 - am
        cum_incl = t * torch.cumprod(one_m, dim=1)
        contrib = (cum_incl >= T_EPS) & (am > 0)
        w = torch.where(contrib, am * (cum_incl / one_m), 0.0)
        acc += torch.einsum("ktc,tcp->tkp", f[FR:FONE + 1], w)
        nc += contrib.sum(1)
        t = cum_incl[:, -1:, :]
    return torch.cat([acc[:, 0:4], 1.0 - acc[:, 4:5], nc[:, None],
                      torch.zeros(n_tiles, 2, p, device=dev)], 1)


def composite_tiles_bwd_torch(pair_feat: torch.Tensor,
                              tile_starts: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, grid_x: int, grid_y: int,
                              tile_x: int, tile_y: int,
                              chunk: int = 128) -> torch.Tensor:
    """The compositor's VJP, vectorised over tiles: per-pair gradients
    [16, M] in sorted-pair order, given the forward output ``out`` and its
    cotangent ``dout`` [T, 8, P] (rows 5-7 of ``dout`` are ignored).

    Chunks are replayed front to back as in the forward.  The five
    channels (rgb, depth and the ones channel, whose cotangent is
    -d final_T) collapse to one scalar per pixel: with e = Σ d5·c for a
    pair and E_total = Σ d5·totals5, the suffix the CUDA reference builds
    back to front is E_total − (Σ_{j<=k} w·e), so
    d_alpha = e·T_excl − (E_total − prefix_incl)/(1−α) where the pair
    contributes, else 0.  Rows 10-15 and pairs that no tile range covers
    stay 0."""
    dev = pair_feat.device
    n_tiles = grid_x * grid_y
    p = tile_x * tile_y
    m = pair_feat.shape[1]
    starts = tile_starts[:-1].to(torch.int64)
    counts = tile_starts[1:].to(torch.int64) - starts
    px, py = tile_pixel_coords(grid_x, grid_y, tile_x, tile_y, dev)

    totals5 = torch.cat([out[:, 0:4], 1.0 - out[:, 4:5]], 1)      # [T,5,P]
    d5 = torch.cat([dout[:, 0:4], -dout[:, 4:5]], 1)              # [T,5,P]
    e_total = (d5 * totals5).sum(1, keepdim=True)                 # [T,1,P]
    grads = torch.zeros(PAIR_FEAT_DIM, m, device=dev)
    prefix = torch.zeros(n_tiles, 1, p, device=dev)
    t = torch.ones(n_tiles, 1, p, device=dev)
    lane = torch.arange(chunk, device=dev)
    n_chunks = -(-int(counts.max()) // chunk) if n_tiles else 0
    for ci in range(n_chunks):
        valid = (ci * chunk + lane)[None, :] < counts[:, None]      # [T,C]
        idx = torch.where(valid, starts[:, None] + ci * chunk + lane, 0)
        f = pair_feat[:, idx]                                       # [16,T,C]
        dx = f[FX][..., None] - px                                  # [T,C,P]
        dy = f[FY][..., None] - py
        ca, cb, cc = (f[FCA][..., None], f[FCB][..., None],
                      f[FCC][..., None])
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g = torch.exp(power)
        alpha = torch.clamp(f[FOP][..., None] * g, max=ALPHA_MAX)
        am = torch.where((power > 0) | (alpha < ALPHA_MIN)
                         | ~valid[..., None], 0.0, alpha)
        one_m = 1.0 - am
        cum_incl = t * torch.cumprod(one_m, dim=1)
        cum_excl = cum_incl / one_m
        contrib = (cum_incl >= T_EPS) & (am > 0)
        w = torch.where(contrib, am * cum_excl, 0.0)

        e = torch.einsum("ktc,tkp->tcp", f[FR:FONE + 1], d5)        # [T,C,P]
        prefix_incl = prefix + torch.cumsum(w * e, dim=1)
        d_alpha = torch.where(
            contrib, e * cum_excl - (e_total - prefix_incl) / one_m, 0.0)
        prefix = prefix_incl[:, -1:]
        t = cum_incl[:, -1:]

        d_power = f[FOP][..., None] * d_alpha * g
        rows = torch.stack([
            (d_power * (-ca * dx - cb * dy)).sum(2),
            (d_power * (-cc * dy - cb * dx)).sum(2),
            (d_power * (-0.5 * dx * dx)).sum(2),
            (d_power * (-dx * dy)).sum(2),
            (d_power * (-0.5 * dy * dy)).sum(2),
            (g * d_alpha).sum(2)], 0)                               # [6,T,C]
        d_colors = torch.einsum("tcp,tkp->ktc", w, d5[:, 0:4])      # [4,T,C]
        vals = torch.cat([rows, d_colors], 0)                       # [10,T,C]
        grads[:N_DATA_ROWS, idx[valid]] = vals[:, valid]
    return grads


def unpack_tiles(out: torch.Tensor, height: int, width: int,
                 grid_x: int, grid_y: int, tile_x: int, tile_y: int):
    """[T, 8, P] tile rows -> dict of image-space maps."""
    img = out.reshape(grid_y, grid_x, N_OUT_ROWS, tile_y, tile_x)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        N_OUT_ROWS, grid_y * tile_y, grid_x * tile_x)[:, :height, :width]
    return {"rgb": img[0:3], "depth": img[3], "final_T": img[4],
            "n_contrib": img[5]}
