"""A trained model rebuilt from its model path, for the offline tools
(``eval_per_view``, ``eval_flow_epe``): the configuration the training
CLI recorded in ``cfg_args`` (config file merged in), the scene read
again, the field initialised from the run's seed and the checkpoint
restored as ``train_cli --eval_only`` restores it."""

from __future__ import annotations

import ast
import os
import sys
from dataclasses import dataclass
from types import SimpleNamespace

from s3gaussian_tpu_torch.config import (ModelHiddenParams, ModelParams,
                                         PipelineParams, RasterConfig,
                                         extract_group)
from s3gaussian_tpu_torch.data.scene import Scene, load_scene
from s3gaussian_tpu_torch.device import configure_device
from s3gaussian_tpu_torch.train import checkpoints as ckpt
from s3gaussian_tpu_torch.train.trainer import TrainState, init_state
from s3gaussian_tpu_torch.train_cli import make_deformation


@dataclass
class RunConfig:
    """The groups of a training run, from its ``cfg_args``."""
    args: SimpleNamespace
    model: ModelParams
    hyper: ModelHiddenParams
    pipe: PipelineParams
    cfg: RasterConfig


@dataclass
class Trained:
    scene: Scene
    state: TrainState
    stage: str
    iteration: int


def read_cfg_args(model_path: str, source: str = "") -> RunConfig:
    """``cfg_args`` of ``model_path``; ``source`` replaces the clip path
    it names."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        args = SimpleNamespace(**ast.literal_eval(f.read()))
    run = RunConfig(args=args, model=extract_group(ModelParams, args),
                    hyper=extract_group(ModelHiddenParams, args),
                    pipe=extract_group(PipelineParams, args),
                    cfg=extract_group(RasterConfig, args))
    if source:
        run.model.source_path = os.path.abspath(source)
    return run


def load_trained(run: RunConfig, model_path: str, checkpoint: str = "",
                 device: str = "cuda", who: str = "") -> Trained:
    """The scene of ``run`` and the train state of ``checkpoint``, or of
    the latest checkpoint under ``model_path``, on ``device``."""
    dev = configure_device(device)
    scene = load_scene(run.model, pool_capacity=run.model.pool_capacity
                       or None, device=dev)
    state = init_state(scene.pool, make_deformation(
        run.hyper, getattr(run.args, "seed", 6666), dev), scene.aabb)
    if checkpoint:
        state, stage, it = ckpt.load_checkpoint(checkpoint, state)
    else:
        state, checkpoint, stage, it = ckpt.restore_latest(model_path, state,
                                                           who)
    print(f"using {checkpoint} ({stage}:{it})", file=sys.stderr)
    return Trained(scene=scene, state=state, stage=stage, iteration=it)
