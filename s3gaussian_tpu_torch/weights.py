"""Load JAX-package state, turned into numpy, into the port's tensors and
modules, so that both packages compute the same thing from the same
weights (``jax.tree_util.tree_map(np.asarray, ...)`` on the JAX side).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from s3gaussian_tpu_torch.config import ModelHiddenParams
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool

POOL_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity", "alive")


def pool_from_numpy(d: Mapping[str, np.ndarray],
                    device: torch.device | str = "cpu") -> GaussianPool:
    """``d`` maps the GaussianPool field names to arrays, e.g.
    ``vars(jax.tree_util.tree_map(np.asarray, pool))``."""
    return GaussianPool(**{k: torch.as_tensor(np.array(d[k]), device=device)
                           for k in POOL_FIELDS})


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _load_linear(lin: nn.Linear, p: Mapping[str, np.ndarray],
                 name: str) -> None:
    # JAX computes x @ w + b with w [in, out]; nn.Linear holds [out, in]
    _copy(lin.weight, np.asarray(p["w"]).T, name + ".w")
    _copy(lin.bias, p["b"], name + ".b")


def _load_head(head: nn.Sequential, p: Mapping[str, Any], name: str) -> None:
    linears = [m for m in head if isinstance(m, nn.Linear)]
    for i, lin in enumerate(linears):
        _load_linear(lin, p[f"l{i + 1}"], f"{name}.l{i + 1}")


@torch.no_grad()
def deformation_from_numpy(tree: Mapping[str, Any], hp: ModelHiddenParams,
                           device: torch.device | str = "cpu"
                           ) -> DeformationField:
    """``tree`` is the ``init_deformation`` pytree of the JAX package
    ({"grid": {scale{s}_plane{i}}, "mlp": {...}, ["empty_voxel"]}) as numpy."""
    field = DeformationField(hp, torch.Generator().manual_seed(0), device)
    grid = tree["grid"]
    if set(grid) != set(field.grid.keys()):
        raise ValueError(f"hexplane keys differ: {sorted(grid)} vs "
                         f"{sorted(field.grid.keys())}")
    for k, v in grid.items():
        _copy(field.grid[k], v, f"grid.{k}")
    mlp = tree["mlp"]
    want = set(field.heads) | {"feature_out"} | (
        {"dino"} if field.dino is not None else set())
    if set(mlp) != want:
        raise ValueError(f"MLP heads differ: {sorted(mlp)} vs {sorted(want)}")
    fo =[m for m in field.feature_out if isinstance(m, nn.Linear)]
    if len(fo) != len(mlp["feature_out"]):
        raise ValueError("feature_out depth differs")
    for i, (lin, p) in enumerate(zip(fo, mlp["feature_out"])):
        _load_linear(lin, p, f"feature_out.{i}")
    for name, head in field.heads.items():
        _load_head(head, mlp[name], name)
    if field.dino is not None:
        _load_head(field.dino, mlp["dino"], "dino")
    if field.empty_voxel is not None:
        _copy(field.empty_voxel, tree["empty_voxel"], "empty_voxel")
    return field
