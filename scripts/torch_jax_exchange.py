#!/usr/bin/env python
"""The JAX package's half of checkpoint interchange with the PyTorch port:
an orbax checkpoint of ``train.py`` (the whole ``TrainState``) becomes an
exchange file, and an exchange file becomes an orbax checkpoint that
``train.py --start_checkpoint``, ``--eval_only``, ``--prior_checkpoint``
and the eval scripts take as they take their own.  The port's half is
``python -m s3gaussian_tpu_torch.tools.exchange``; the file's layout is
``s3gaussian_tpu_torch/utils/exchange_file.py`` (numpy only).  This
script imports the JAX package, orbax and numpy, never torch, and
converts on the host's CPU.

    python scripts/torch_jax_exchange.py export --model_path out/ \\
        [--checkpoint out/chkpnt_fine_50000] --out run.npz
    python scripts/torch_jax_exchange.py import --exchange run.npz \\
        --model_path out2/
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s3gaussian_tpu_torch.utils import exchange_file as xf  # noqa: E402


def _stage(path: str):
    with open(os.path.join(path, "STAGE")) as f:
        stage, it = f.read().split()
    return stage, int(it)


def export(model_path: str, out: str, checkpoint: str = "") -> str:
    """The latest checkpoint under ``model_path`` (or ``checkpoint``),
    restored by orbax with no template, written to the exchange file
    ``out`` with the run's ``cfg_args``."""
    import orbax.checkpoint as ocp

    from s3gaussian_tpu.train.checkpoints import _np, find_checkpoint

    if not checkpoint:
        found = find_checkpoint(model_path)
        if found is None:
            raise SystemExit(f"export: no checkpoint under {model_path}")
        checkpoint = found[0]
    tree = ocp.StandardCheckpointer().restore(os.path.abspath(checkpoint))
    with open(os.path.join(model_path, "cfg_args")) as f:
        cfg_args = f.read()
    stage, it = _stage(checkpoint)
    xf.write(out, {k: _np(v) for k, v in xf.flatten(tree).items()},
             stage=stage, iteration=it, cfg_args=cfg_args,
             written_by="s3gaussian_tpu")
    print(f"exported {checkpoint} ({stage}:{it}) -> {out}, "
          f"{os.path.getsize(out)} bytes")
    return out


def template(hp, sh_degree: int, capacity: int):
    """The shapes and dtypes of a ``TrainState`` with field ``hp`` and a
    pool of ``capacity`` rows at ``sh_degree`` (nothing allocated)."""
    import jax
    import jax.numpy as jnp

    from s3gaussian_tpu.models.deformation import init_deformation
    from s3gaussian_tpu.models.pool import GaussianPool
    from s3gaussian_tpu.train.trainer import init_state

    rest = (sh_degree + 1) ** 2 - 1

    def build():
        def z(*shape):
            return jnp.zeros((capacity,) + shape, jnp.float32)
        pool = GaussianPool(xyz=z(3), features_dc=z(1, 3),
                            features_rest=z(rest, 3), scaling=z(3),
                            rotation=z(4), opacity=z(1),
                            alive=jnp.zeros(capacity, bool))
        return init_state(pool, init_deformation(jax.random.PRNGKey(0), hp),
                          jnp.zeros((2, 3), jnp.float32))
    return jax.eval_shape(build)


def import_(exchange: str, model_path: str) -> str:
    """The exchange file as a ``chkpnt_{stage}_{iteration}`` orbax
    checkpoint under ``model_path``, saved by the package's own
    ``save_checkpoint``, beside ``cfg_args`` (``model_path`` rewritten)."""
    import jax
    import jax.numpy as jnp

    from s3gaussian_tpu.config import (ModelHiddenParams, ModelParams,
                                       extract_group)
    from s3gaussian_tpu.models.pool import GaussianPool, PoolStats
    from s3gaussian_tpu.train.checkpoints import save_checkpoint
    from s3gaussian_tpu.train.optim import AdamState
    from s3gaussian_tpu.train.trainer import TrainState

    arrays, meta = xf.read(exchange)
    args = ast.literal_eval(meta["cfg_args"])
    ns = SimpleNamespace(**args)
    model = extract_group(ModelParams, ns)
    hp = extract_group(ModelHiddenParams, ns)
    if "pool/xyz" not in arrays:
        raise ValueError(f"{exchange}: missing key pool/xyz")
    want = template(hp, model.sh_degree, arrays["pool/xyz"].shape[0])
    xf.check(arrays, xf.spec(xf.flatten(want)), exchange, meta["bf16_keys"])
    for k in meta["bf16_keys"]:
        arrays[k] = arrays[k].view(jnp.bfloat16)
    t = jax.tree_util.tree_map(jnp.asarray, xf.unflatten(arrays))
    state = TrainState(
        pool=GaussianPool(**t["pool"]), deform=t["deform"],
        adam=AdamState(**t["adam"]), stats=PoolStats(**t["stats"]),
        step=t["step"], aabb=t["aabb"], nan_skips=t["nan_skips"])
    os.makedirs(model_path, exist_ok=True)
    path = save_checkpoint(model_path, meta["stage"], meta["iteration"],
                           state)
    args["model_path"] = model_path
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args))
    print(f"imported {exchange} (written by {meta['written_by']}) -> {path} "
          f"({meta['stage']}:{meta['iteration']}), pool capacity "
          f"{arrays['pool/xyz'].shape[0]}")
    return path


def main(argv=None) -> None:
    import jax

    # a conversion needs no accelerator
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    exp = sub.add_parser("export", help="orbax checkpoint -> exchange file")
    exp.add_argument("--model_path", required=True)
    exp.add_argument("--checkpoint", default="")
    exp.add_argument("--out", required=True)
    imp = sub.add_parser("import", help="exchange file -> orbax checkpoint")
    imp.add_argument("--exchange", required=True)
    imp.add_argument("--model_path", required=True)
    args = p.parse_args(argv)
    if args.cmd == "export":
        export(args.model_path, args.out, args.checkpoint)
    else:
        import_(args.exchange, args.model_path)


if __name__ == "__main__":
    main()
