# Plain stand-in for s3gaussian_tpu_torch/ops/tile_kernels.py at commit
# 0fe8bd83fbe2d3b430992244fdc79098999720ec: the compositor's autograd function with the plain PyTorch
# forward and backward (ops/composite.py) on every device; no CUDA kernel.
"""The tile compositor of the plain reference: CompositeTiles with
composite_tiles_torch as its forward and composite_tiles_bwd_torch
as its backward, whatever the device."""

from __future__ import annotations

import torch

from benchmark.frozen.ref.ops.composite import (composite_tiles_bwd_torch,
                                                composite_tiles_torch)


class CompositeTiles(torch.autograd.Function):
    """The plain compositor; the gradient flows to pair_feat only."""

    @staticmethod
    def forward(ctx, pair_feat: torch.Tensor, tile_starts: torch.Tensor,
                grid_x: int, grid_y: int, tile_x: int,
                tile_y: int) -> torch.Tensor:
        out = composite_tiles_torch(pair_feat, tile_starts, grid_x, grid_y,
                                    tile_x, tile_y)
        ctx.save_for_backward(pair_feat, tile_starts, out)
        ctx.dims = (grid_x, grid_y, tile_x, tile_y)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        pair_feat, tile_starts, out = ctx.saved_tensors
        grads = composite_tiles_bwd_torch(pair_feat, tile_starts, out,
                                          dout.contiguous(), *ctx.dims)
        return grads, None, None, None, None, None
