"""The exchange file: one train state of either package as a plain numpy
``.npz``, so that a run trained by the JAX package resumes in the port
and the other way (``tools/exchange.py`` is the port's half,
``scripts/torch_jax_exchange.py`` the JAX package's).  This module is
numpy only: both halves import it, and the JAX half never imports torch.

Layout, version 1:

  * one array per leaf of the JAX package's ``TrainState``, keyed by its
    tree path joined by ``/`` (the JAX layout is the canonical one):
    ``pool/xyz`` ... ``pool/alive``, ``deform/grid/scale0_plane0``,
    ``deform/mlp/feature_out/0/w`` (a linear's weight ``[in, out]``; a
    list's elements by position), ``deform/mlp/<head>/l1/b``,
    ``adam/mu/pool/<group>``, ``adam/mu/deform/...``, the same under
    ``adam/nu/``, ``adam/count``, ``stats/max_radii2d``,
    ``stats/xyz_grad_accum``, ``stats/denom``, ``step``, ``aabb``,
    ``nan_skips``;
  * 0-d ``meta/`` entries: ``meta/version``, ``meta/stage``,
    ``meta/iteration``, ``meta/cfg_args`` (the run's ``cfg_args`` text),
    ``meta/written_by``, and ``meta/bf16_keys``, the keys whose arrays
    hold the raw ``uint16`` bits of a bfloat16 leaf (never widened).

Every array keeps its dtype.  The file is written with ``np.savez`` and
read with ``allow_pickle=False``; a reader refuses, naming it, a version
it does not know, a missing key, an extra key and an array whose dtype
or shape is not the one the run's configuration gives.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np

VERSION = 1
META = "meta/"
WRITERS = ("s3gaussian_tpu", "s3gaussian_tpu_torch")
META_KEYS = ("version", "stage", "iteration", "cfg_args", "written_by",
             "bf16_keys")
# the leaves whose leading axis is the pool's capacity
CAPACITY_PREFIXES = ("pool/", "stats/", "adam/mu/pool/", "adam/nu/pool/")

Spec = Dict[str, Tuple[Tuple[int, ...], np.dtype]]


def _is_leaf(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _children(x: Any) -> Iterable[Tuple[str, Any]]:
    if isinstance(x, Mapping):
        return ((str(k), v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(x))
    return vars(x).items()


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path joined by '/': leaf} of a tree of mappings, lists and
    dataclass-like objects (their fields in ``vars`` order); a leaf is
    anything with a shape and a dtype."""
    if _is_leaf(tree):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in _children(tree):
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The nested mappings of ``flat``'s paths; a level whose keys are
    exactly ``0..n-1`` becomes a list."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def spec(flat: Mapping[str, Any]) -> Spec:
    """{key: (shape, dtype)} of flattened leaves (numpy arrays, or any
    array whose dtype numpy names)."""
    return {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in flat.items()}


def with_capacity(want: Spec, capacity: int) -> Spec:
    """``want`` with the pool's rows set to ``capacity``: a template state
    is built at any capacity, and the file's pool sets the rows."""
    return {k: ((capacity,) + s[1:] if k.startswith(CAPACITY_PREFIXES)
                else s, d) for k, (s, d) in want.items()}


def write(path: str, flat: Mapping[str, Any], *, stage: str, iteration: int,
          cfg_args: str, written_by: str) -> None:
    """``flat`` (numpy arrays) and the meta entries to ``path``; a
    bfloat16 array is stored as its raw uint16 bits."""
    if written_by not in WRITERS:
        raise ValueError(f"written_by {written_by!r} is not one of {WRITERS}")
    arrays, bf16 = {}, []
    for k, v in flat.items():
        if k.startswith(META):
            raise ValueError(f"{k}: a state key may not start with {META}")
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            v = v.view(np.uint16)
            bf16.append(k)
        arrays[k] = v
    meta = {"version": np.array(VERSION), "stage": np.array(stage),
            "iteration": np.array(int(iteration)),
            "cfg_args": np.array(cfg_args), "written_by": np.array(written_by),
            "bf16_keys": np.array(sorted(bf16), dtype=str)}
    with open(path, "wb") as f:
        np.savez(f, **arrays, **{META + k: v for k, v in meta.items()})


def read(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(state arrays by key, meta) of the exchange file at ``path``.  The
    arrays named in ``meta["bf16_keys"]`` hold raw bfloat16 bits."""
    with np.load(path, allow_pickle=False) as z:
        keys = list(z.files)
        missing = [META + k for k in META_KEYS if META + k not in keys]
        if missing:
            raise ValueError(f"{path}: not an exchange file, no {missing[0]}")
        version = int(z[META + "version"])
        if version != VERSION:
            raise ValueError(f"{path}: meta/version {version} is not a "
                             f"version this reader knows ({VERSION})")
        extra = [k for k in keys if k.startswith(META)
                 and k[len(META):] not in META_KEYS]
        if extra:
            raise ValueError(f"{path}: unknown key {extra[0]}")
        meta = {"version": version, "stage": str(z[META + "stage"]),
                "iteration": int(z[META + "iteration"]),
                "cfg_args": str(z[META + "cfg_args"]),
                "written_by": str(z[META + "written_by"]),
                "bf16_keys": [str(k) for k in z[META + "bf16_keys"]]}
        arrays = {k: z[k] for k in keys if not k.startswith(META)}
    unknown = [k for k in meta["bf16_keys"] if k not in arrays]
    if unknown:
        raise ValueError(f"{path}: meta/bf16_keys names {unknown[0]}, which "
                         f"the file does not hold")
    return arrays, meta


def check(arrays: Mapping[str, np.ndarray], want: Spec, path: str = "",
          bf16_keys: List[str] = ()) -> None:
    """Refuse, naming the key, a key of ``want`` that ``arrays`` lacks,
    one that ``want`` does not have, and an array whose shape or dtype
    differs (a ``bf16_keys`` array is held as bfloat16 bits: uint16
    where ``want`` says bfloat16)."""
    where = f"{path}: " if path else ""
    for k in want:
        if k not in arrays:
            raise ValueError(f"{where}missing key {k}")
    for k in arrays:
        if k not in want:
            raise ValueError(f"{where}extra key {k}, which this run's "
                             f"configuration does not have")
    for k, (shape, dtype) in want.items():
        got = arrays[k]
        got_dtype = "bfloat16" if k in bf16_keys else got.dtype.name
        if got_dtype != dtype.name:
            raise ValueError(f"{where}{k} has dtype {got_dtype}, the run "
                             f"{dtype.name}")
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"{where}{k} has shape {tuple(got.shape)}, the "
                             f"run {tuple(shape)}")
