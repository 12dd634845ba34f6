"""The port's half of checkpoint interchange with the JAX package: an
exchange file (``utils/exchange_file.py``) becomes a checkpoint of the
port under a model path, and a checkpoint of the port becomes an
exchange file.  ``scripts/torch_jax_exchange.py`` is the JAX package's
half (orbax checkpoint <-> exchange file); it needs jax and orbax, this
half neither.

    python -m s3gaussian_tpu_torch.tools.exchange import \\
        --exchange run.npz --model_path out/
    python -m s3gaussian_tpu_torch.tools.exchange export \\
        --model_path out/ [--checkpoint out/chkpnt_fine_120] --out run.npz

An import writes ``chkpnt_{stage}_{iteration}/state.pt`` and ``STAGE``
with ``train/checkpoints.py::save_checkpoint`` and ``cfg_args`` from the
file's (``model_path`` rewritten), so that ``train_cli
--start_checkpoint``, ``--eval_only``, ``--prior_checkpoint``, the
offline tools and ``tools/run_scenes.py --prior_root`` take the run as
they take one trained by the port.  The state is built and saved on the
CPU; only the state returned lies on ``device``.  ``load_checkpoint``
refuses a pool whose capacity the scene reader does not give, so the
import prints the capacity the run needs (``--pool_capacity``).

The JAX-only fields of a JAX run's ``cfg_args`` (``JAX_ONLY``: TPU
layout and memory switches the port has no counterpart of) are printed
and kept in the new ``cfg_args``, so that an export gives them back;
one that changes what the run computed, which the port would not
reproduce, is refused: ``max_pairs_per_tile`` below the pairs a tile
can hold, in a run that forced the jnp compositor (``use_pallas``
False), which cuts each tile there (the Pallas kernels and the port do
not).
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

from s3gaussian_tpu_torch.config import (FieldParams, ModelHiddenParams,
                                         ModelParams, extract_group)
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import create_from_pcd
from s3gaussian_tpu_torch.train import checkpoints as ckpt
from s3gaussian_tpu_torch.train.trainer import TrainState, init_state
from s3gaussian_tpu_torch.utils import exchange_file as xf
from s3gaussian_tpu_torch.weights import (train_state_from_numpy,
                                          train_state_to_numpy)

JAX_ONLY = ("max_pairs_per_tile", "multicam_scan", "multicam_serialize",
            "remat_deform", "sort_bf16", "sort_hier", "use_pallas")
# the levels of the state tree that are dataclasses in the JAX package
_DATACLASSES = ("pool", "adam", "stats")


def _field(hp: ModelHiddenParams, device) -> DeformationField:
    return DeformationField(hp, torch.Generator().manual_seed(0), device)


def _run_groups(cfg_args: str):
    """(the args, ModelParams, ModelHiddenParams) of ``cfg_args``;
    raises on a run whose field is not the hexplane field, the only one
    an exchange file (the JAX package's state) can hold."""
    args = ast.literal_eval(cfg_args)
    ns = SimpleNamespace(**args)
    kind = extract_group(FieldParams, ns).field_kind
    if kind != "hexplane":
        raise ValueError(f"the run trains a {kind} deformation field; an "
                         f"exchange file holds the JAX package's state, "
                         f"whose field is the hexplane field alone")
    return (args, extract_group(ModelParams, ns),
            extract_group(ModelHiddenParams, ns))


def jax_only_fields(args: Dict[str, Any]) -> Dict[str, Any]:
    """The ``JAX_ONLY`` fields of ``args``; raises on one that changed
    what the JAX run computed (the module's docstring)."""
    carried = {k: args[k] for k in JAX_ONLY if k in args}
    cap = carried.get("max_pairs_per_tile")
    holds = [v for v in (args.get("max_visible", 0), args.get("pair_budget", 0))
             if v > 0]
    if carried.get("use_pallas") is False and cap is not None and holds \
            and cap < min(holds):
        raise ValueError(
            f"max_pairs_per_tile={cap} with use_pallas=False: the run's jnp "
            f"compositor cut each tile at {cap} pairs, below the {min(holds)} "
            f"a tile can hold (max_visible, pair_budget); the port composites "
            f"every pair, so it would not compute what this run trained")
    return carried


def expected(hp: ModelHiddenParams, sh_degree: int, capacity: int) -> xf.Spec:
    """{key: (shape, dtype)} of the exchange file of a run with field
    ``hp`` and a pool of ``capacity`` rows at ``sh_degree``."""
    one = np.zeros((1, 3), np.float32)
    template = init_state(create_from_pcd(one, one, 1, sh_degree, "cpu"),
                          _field(hp, "cpu"), torch.zeros(2, 3))
    return xf.with_capacity(xf.spec(xf.flatten(train_state_to_numpy(
        template))), capacity)


def state_tree(flat: Dict[str, np.ndarray]) -> SimpleNamespace:
    """The tree ``train_state_from_numpy`` reads from an exchange file's
    arrays: the dataclass levels as namespaces, ``feature_out`` a list."""
    tree = xf.unflatten(flat)
    for k in _DATACLASSES:
        tree[k] = SimpleNamespace(**tree[k])
    return SimpleNamespace(**tree)


def import_run(exchange: str, model_path: str, device: str = "cuda"
               ) -> TrainState:
    """The exchange file ``exchange`` as a checkpoint of the port under
    ``model_path`` (with ``cfg_args``); returns the state on ``device``."""
    dev = configure_device(device)
    arrays, meta = xf.read(exchange)
    args, model, hp = _run_groups(meta["cfg_args"])
    carried = jax_only_fields(args)
    if meta["bf16_keys"]:
        raise ValueError(f"{exchange}: {meta['bf16_keys'][0]} is bfloat16; "
                         f"the port holds the state in float32 and widens "
                         f"nothing")
    if "pool/xyz" not in arrays:
        raise ValueError(f"{exchange}: missing key pool/xyz")
    capacity = arrays["pool/xyz"].shape[0]
    xf.check(arrays, expected(hp, model.sh_degree, capacity), exchange)
    state = train_state_from_numpy(state_tree(arrays), hp, "cpu")
    os.makedirs(model_path, exist_ok=True)
    path = ckpt.save_checkpoint(model_path, meta["stage"], meta["iteration"],
                                state)
    args["model_path"] = model_path
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args))
    print(f"imported {exchange} (written by {meta['written_by']}) -> {path} "
          f"({meta['stage']}:{meta['iteration']}); pool capacity "
          f"{capacity}, {int(state.pool.n_alive)} alive: the scene reader "
          f"must give {capacity} rows (--pool_capacity {capacity} where it "
          f"sizes the pool otherwise)")
    if carried:
        print("JAX-only fields kept in cfg_args, which the port ignores: "
              + ", ".join(f"{k}={v!r}" for k, v in carried.items()))
    if dev.type == "cpu":
        return state
    del state
    return ckpt.read_checkpoint(path, _field(hp, dev), dev)[0]


def export_run(model_path: str, out: str, checkpoint: str = "",
               device: str = "cuda") -> str:
    """The checkpoint ``checkpoint``, or the latest under ``model_path``,
    restored on ``device`` and written to the exchange file ``out`` with
    the run's ``cfg_args``.  Returns ``out``."""
    dev = configure_device(device)
    if not checkpoint:
        found = ckpt.find_checkpoint(model_path)
        if found is None:
            raise SystemExit(f"export: no checkpoint under {model_path}")
        checkpoint = found[0]
    with open(os.path.join(model_path, "cfg_args")) as f:
        cfg_args = f.read()
    _, _, hp = _run_groups(cfg_args)
    state, stage, it = ckpt.read_checkpoint(checkpoint, _field(hp, dev), dev)
    xf.write(out, xf.flatten(train_state_to_numpy(state)), stage=stage,
             iteration=it, cfg_args=cfg_args,
             written_by="s3gaussian_tpu_torch")
    print(f"exported {checkpoint} ({stage}:{it}) -> {out}, "
          f"{os.path.getsize(out)} bytes")
    return out


def main(argv=None, device: str = "cuda") -> None:
    p = argparse.ArgumentParser(description="checkpoint interchange with "
                                "the JAX package (exchange files)")
    sub = p.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import", help="exchange file -> checkpoint")
    imp.add_argument("--exchange", required=True)
    imp.add_argument("--model_path", required=True)
    exp = sub.add_parser("export", help="checkpoint -> exchange file")
    exp.add_argument("--model_path", required=True)
    exp.add_argument("--checkpoint", default="")
    exp.add_argument("--out", required=True)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    if args.cmd == "import":
        import_run(args.exchange, args.model_path, device)
    else:
        export_run(args.model_path, args.out, args.checkpoint, device)
    print(f"{args.cmd}: {time.perf_counter() - t0:.2f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
