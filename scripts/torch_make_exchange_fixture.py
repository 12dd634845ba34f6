#!/usr/bin/env python
"""Writes ``tests/fixtures/jax_exchange_tiny.npz``: a scene trained by the
JAX package on the CPU, for the port to render and train on.

``train.py`` runs ``tests/tiny_config.py`` (the tiny hexplane) on the
fabricated Waymo clip of ``tests/waymo_fixture.py`` for 3 coarse and 6
fine steps (a densify at fine step 4, a pool of 2048 rows), then
``scripts/torch_jax_exchange.py export`` writes its final checkpoint as
an exchange file.  The fixture holds:

  * ``exchange``: the bytes of that exchange file;
  * ``camera/*``: the first train camera of the clip (``world_view``,
    ``full_proj``, ``campos``, ``time``, ``fovx``, ``fovy``, ``height``,
    ``width``) and ``sh_degree``;
  * ``render/rgb`` [3,H,W], ``render/depth`` [H,W]: the JAX package's
    float32 render of that camera (the fine stage, black background, the
    run's raster settings, the jnp compositor).

    python scripts/torch_make_exchange_fixture.py [--out PATH]
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import importlib.util
import io
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_exchange_tiny.npz")
COARSE, FINE = 3, 6
ARGV = ["--num_pts", "500", "--pool_capacity", "2048",
        "--coarse_iterations", str(COARSE), "--iterations", str(FINE),
        "--densification_interval", "4", "--densify_from_iter", "2",
        "--opacity_reset_interval", "1000", "--checkpoint_iterations",
        str(FINE), "--max_visible", "2048", "--rect_w", "4", "--rect_h", "4",
        "--chunk", "32", "--load_h", "64", "--load_w", "96",
        "--seed", "6666", "--max_pairs_per_tile", "512", "--skip_final_eval"]


def exchange_script():
    """``scripts/torch_jax_exchange.py`` as a module."""
    path = os.path.join(REPO, "scripts", "torch_jax_exchange.py")
    spec = importlib.util.spec_from_file_location("torch_jax_exchange", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train(root: str):
    """The clip under ``root/clip`` and ``train.py``'s run of it under
    ``root/jax`` (the tiny config copied to ``root``): (clip, model
    path)."""
    import train as jax_cli
    from waymo_fixture import make_fixture

    clip = make_fixture(os.path.join(root, "clip"), n_frames=3)
    out = os.path.join(root, "jax")
    config = os.path.join(root, "tiny_config.py")
    shutil.copyfile(os.path.join(REPO, "tests", "tiny_config.py"), config)
    old = os.environ.pop("S3G_LPIPS_WEIGHTS", None)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_cli.main(["-s", clip, "--model_path", out, "--configs",
                          config] + ARGV)
    finally:
        if old is not None:
            os.environ["S3G_LPIPS_WEIGHTS"] = old
    return clip, out


def fixture_arrays(model_path: str) -> Dict[str, np.ndarray]:
    """The fixture's arrays for the run at ``model_path``."""
    import jax
    import jax.numpy as jnp

    from s3gaussian_tpu.config import (ModelHiddenParams, ModelParams,
                                       PipelineParams, RasterConfig,
                                       extract_group)
    from s3gaussian_tpu.data.scene import load_scene
    from s3gaussian_tpu.models.deformation import init_deformation
    from s3gaussian_tpu.render.renderer import render
    from s3gaussian_tpu.train import checkpoints as ckpt
    from s3gaussian_tpu.train.trainer import init_state

    with open(os.path.join(model_path, "cfg_args")) as f:
        ns = SimpleNamespace(**ast.literal_eval(f.read()))
    model, pipe, hp, cfg = (extract_group(c, ns) for c in (
        ModelParams, PipelineParams, ModelHiddenParams, RasterConfig))
    scene = load_scene(model, pool_capacity=model.pool_capacity or None)
    state = init_state(scene.pool, init_deformation(
        jax.random.PRNGKey(0), hp), scene.aabb)
    path, _, _ = ckpt.find_checkpoint(model_path)
    state, _, _ = ckpt.load_checkpoint(path, state)
    cam = scene.get_train_cameras()[0]
    out = render(cam, state.pool, state.deform, hp, pipe, jnp.zeros(3),
                 state.aabb, model.sh_degree, "fine", cfg=cfg)
    with tempfile.TemporaryDirectory() as tmp:
        exchange = os.path.join(tmp, "run.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            exchange_script().export(model_path, exchange)
        with open(exchange, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
    return {
        "exchange": raw,
        "camera/world_view": np.asarray(cam.world_view, np.float32),
        "camera/full_proj": np.asarray(cam.full_proj, np.float32),
        "camera/campos": np.asarray(cam.campos, np.float32),
        "camera/time": np.asarray(cam.time, np.float32),
        "camera/fovx": np.asarray(cam.fovx, np.float32),
        "camera/fovy": np.asarray(cam.fovy, np.float32),
        "camera/height": np.asarray(cam.image_height, np.int32),
        "camera/width": np.asarray(cam.image_width, np.int32),
        "sh_degree": np.asarray(model.sh_degree, np.int32),
        "render/rgb": np.asarray(out["render"], np.float32),
        "render/depth": np.asarray(out["depth"], np.float32),
    }


def main(argv=None) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description="writes the JAX exchange "
                                "fixture of the port's tests")
    p.add_argument("--out", default=FIXTURE)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        _, model_path = train(root)
        arrays = fixture_arrays(model_path)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, the "
          f"exchange file {arrays['exchange'].size} bytes")


if __name__ == "__main__":
    main()
