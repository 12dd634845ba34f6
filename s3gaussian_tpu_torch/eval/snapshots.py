"""Training-time image snapshots (port of
``s3gaussian_tpu/eval/snapshots.py``): a labelled GT | render | depth
strip saved during training at the reference cadence (train.py:477-487),
rendered through the port's ``render()`` without gradient and labelled
with PIL, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from s3gaussian_tpu_torch.eval.visualization import to8b, visualize_depth
from s3gaussian_tpu_torch.render.renderer import render


@torch.no_grad()
def render_training_image(model_path: str, tag: str, iteration: int,
                          camera, pool, deform, pipe, bg, aabb,
                          active_sh_degree: int, stage: str, cfg,
                          elapsed: float = 0.0) -> str:
    from PIL import Image, ImageDraw

    pkg = render(camera, pool, deform, pipe, bg, aabb, active_sh_degree,
                 stage=stage, cfg=cfg)
    rgb = torch.round(torch.clamp(pkg["render"], 0.0, 1.0).permute(1, 2, 0)
                      * 255.0).to(torch.uint8).cpu().numpy()
    gt = to8b(camera.image.cpu().numpy())
    depth = visualize_depth(pkg["depth"].cpu().numpy())
    img = Image.fromarray(np.concatenate([gt, rgb, depth], axis=1))
    label = (f"{stage} it {iteration}  t={float(camera.time):.2f}  "
             f"elapsed {elapsed:.0f}s")
    ImageDraw.Draw(img).text((8, 8), label, fill=(255, 255, 0))
    out_dir = os.path.join(model_path, "train_render")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}_{iteration:05d}.png")
    img.save(path)
    return path
