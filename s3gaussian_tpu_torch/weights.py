"""Load JAX-package state, turned into numpy, into the port's tensors and
modules, so that both packages compute the same thing from the same
weights (``jax.tree_util.tree_map(np.asarray, ...)`` on the JAX side).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from s3gaussian_tpu_torch.config import ModelHiddenParams
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool, PoolStats
from s3gaussian_tpu_torch.train.optim import AdamState
from s3gaussian_tpu_torch.train.trainer import TrainState

POOL_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity", "alive")


def pool_from_numpy(d: Mapping[str, np.ndarray],
                    device: torch.device | str = "cuda") -> GaussianPool:
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


def _linears(seq: nn.Sequential) -> List[nn.Linear]:
    return [m for m in seq if isinstance(m, nn.Linear)]


def _deform_leaves(field: DeformationField
                   ) -> List[Tuple[str, Tuple[Any, ...], bool]]:
    """(parameter name, JAX pytree path, transpose) for every parameter of
    the field.  JAX computes x @ w + b with w [in, out]; nn.Linear holds
    [out, in], hence the transpose."""
    names = {id(p): n for n, p in field.named_parameters()}
    leaves = [(names[id(p)], ("grid", k), False)
              for k, p in field.grid.items()]

    def linear(lin, path):
        leaves.append((names[id(lin.weight)], path + ("w",), True))
        leaves.append((names[id(lin.bias)], path + ("b",), False))

    for i, lin in enumerate(_linears(field.feature_out)):
        linear(lin, ("mlp", "feature_out", i))
    heads = dict(field.heads.items())
    if field.dino is not None:
        heads["dino"] = field.dino
    for name, head in heads.items():
        for i, lin in enumerate(_linears(head)):
            linear(lin, ("mlp", name, f"l{i + 1}"))
    if field.empty_voxel is not None:
        leaves.append(("empty_voxel", ("empty_voxel",), False))
    return leaves


def _at(tree: Any, path: Tuple[Any, ...]) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _check_structure(tree: Mapping[str, Any], field: DeformationField):
    grid = tree["grid"]
    if set(grid) != set(field.grid.keys()):
        raise ValueError(f"hexplane keys differ: {sorted(grid)} vs "
                         f"{sorted(field.grid.keys())}")
    mlp = tree["mlp"]
    want = set(field.heads) | {"feature_out"} | (
        {"dino"} if field.dino is not None else set())
    if set(mlp) != want:
        raise ValueError(f"MLP heads differ: {sorted(mlp)} vs {sorted(want)}")
    if len(_linears(field.feature_out)) != len(mlp["feature_out"]):
        raise ValueError("feature_out depth differs")


def _deform_arrays(tree: Mapping[str, Any], field: DeformationField
                   ) -> List[Tuple[str, np.ndarray]]:
    """(parameter name, array in the port's layout) for every parameter,
    from a pytree shaped like the JAX field's params."""
    _check_structure(tree, field)
    return [(name, _at(tree, path).T if transpose else _at(tree, path))
            for name, path, transpose in _deform_leaves(field)]


@torch.no_grad()
def deformation_from_numpy(tree: Mapping[str, Any], hp: ModelHiddenParams,
                           device: torch.device | str = "cuda"
                           ) -> DeformationField:
    """``tree`` is the ``init_deformation`` pytree of the JAX package
    ({"grid": {scale{s}_plane{i}}, "mlp": {...}, ["empty_voxel"]}) as numpy."""
    field = DeformationField(hp, torch.Generator().manual_seed(0), device)
    params = dict(field.named_parameters())
    for name, arr in _deform_arrays(tree, field):
        _copy(params[name], arr, name)
    return field


def train_state_from_numpy(tree: Any, hp: ModelHiddenParams,
                           device: torch.device | str = "cuda"
                           ) -> TrainState:
    """A JAX ``TrainState`` passed through
    ``jax.tree_util.tree_map(np.asarray, ...)`` -> the port's TrainState:
    pool, field, Adam moments and count, PoolStats, step, aabb and the
    watchdog's count.  Moments keep the port's layout: ``pool`` by the
    pool's group names, ``deform`` by parameter name."""
    pool = pool_from_numpy(vars(tree.pool), device)
    field = deformation_from_numpy(tree.deform, hp, device)
    params = dict(field.named_parameters())

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    def moments(m):
        deform = {}
        for name, arr in _deform_arrays(m["deform"], field):
            deform[name] = torch.zeros_like(params[name])
            _copy(deform[name], arr, name)
        return {"pool": {k: t(v) for k, v in m["pool"].items()},
                "deform": deform}

    adam = AdamState(mu=moments(tree.adam.mu), nu=moments(tree.adam.nu),
                     count=t(tree.adam.count, torch.int32))
    stats = PoolStats(max_radii2d=t(tree.stats.max_radii2d),
                      xyz_grad_accum=t(tree.stats.xyz_grad_accum),
                      denom=t(tree.stats.denom))
    return TrainState(pool=pool, deform=field, adam=adam, stats=stats,
                      step=t(tree.step, torch.int32), aabb=t(tree.aabb),
                      nan_skips=t(tree.nan_skips, torch.int32))


def _put(tree: Dict[Any, Any], path: Tuple[Any, ...], value: np.ndarray
         ) -> None:
    """``value`` at ``path`` of a nested dict, an integer element of the
    path naming a list position (``feature_out``'s, which
    ``_deform_leaves`` gives in order)."""
    node: Any = tree
    for k, nxt in zip(path[:-1], path[1:]):
        new = [] if isinstance(nxt, int) else {}
        if isinstance(node, list) and k == len(node):
            node.append(new)
        elif isinstance(node, dict) and k not in node:
            node[k] = new
        node = node[k]
    node[path[-1]] = value


def _deform_tree(field: DeformationField, tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, Any]:
    """The JAX field's pytree of ``tensors`` (the field's parameters, or
    a moment of each, by parameter name), linear weights back to
    ``[in, out]``."""
    tree: Dict[str, Any] = {}
    for name, path, transpose in _deform_leaves(field):
        arr = tensors[name].detach().cpu().numpy()
        _put(tree, path, arr.T.copy() if transpose else arr.copy())
    return tree


@torch.no_grad()
def train_state_to_numpy(state: TrainState) -> SimpleNamespace:
    """The inverse of ``train_state_from_numpy``: the port's TrainState
    as the JAX package's ``TrainState`` tree of numpy arrays, its
    dataclasses as namespaces with the same fields (``pool``, ``deform``,
    ``adam`` with ``mu``/``nu``/``count``, ``stats``, ``step``, ``aabb``,
    ``nan_skips``).  The field's moments are placed by parameter name,
    never by position; every array keeps its dtype."""
    def a(x):
        return x.detach().cpu().numpy().copy()

    field = state.deform
    params = dict(field.named_parameters())

    def moments(m):
        return {"pool": {k: a(v) for k, v in m["pool"].items()},
                "deform": _deform_tree(field, m["deform"])}

    return SimpleNamespace(
        pool=SimpleNamespace(**{k: a(getattr(state.pool, k))
                                for k in POOL_FIELDS}),
        deform=_deform_tree(field, params),
        adam=SimpleNamespace(mu=moments(state.adam.mu),
                             nu=moments(state.adam.nu),
                             count=a(state.adam.count)),
        stats=SimpleNamespace(max_radii2d=a(state.stats.max_radii2d),
                              xyz_grad_accum=a(state.stats.xyz_grad_accum),
                              denom=a(state.stats.denom)),
        step=a(state.step), aabb=a(state.aabb),
        nan_skips=a(state.nan_skips))


def lpips_weights_from_numpy(d: Mapping[str, np.ndarray],
                             device: torch.device | str = "cuda"
                             ) -> Dict[str, torch.Tensor]:
    """LPIPS weights from the arrays of an ``.npz`` that the JAX package's
    ``eval/lpips_jax.py`` reads (``net.slice{k}.{i}.weight|bias`` of the
    feature stack, ``lin{j}.weight`` of the heads), as float32 tensors."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in d.items()}
