"""Evaluation render loop (port of the render loop of
``s3gaussian_tpu/eval/video.py::render_pixels``).

Metrics, LPIPS, scene flow and video writing are not ported yet
(ROADMAP.md).  Frames stay float32 on the render device: the JAX sweep's
uint8 download exists to cut transfers from a remote TPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from s3gaussian_tpu_torch.config import PipelineParams, RasterConfig
from s3gaussian_tpu_torch.data.cameras import Camera
from s3gaussian_tpu_torch.models.deformation import DeformationField
from s3gaussian_tpu_torch.models.pool import GaussianPool
from s3gaussian_tpu_torch.render.renderer import render


def _frame(img: torch.Tensor) -> torch.Tensor:
    """[3,H,W] render -> [H,W,3] clipped to [0, 1]."""
    return torch.clamp(img, 0.0, 1.0).permute(1, 2, 0)


@torch.no_grad()
def render_pixels(cameras: Sequence[Camera], pool: GaussianPool,
                  deform: Optional[DeformationField], pipe: PipelineParams,
                  bg: torch.Tensor, aabb: Optional[torch.Tensor],
                  active_sh_degree: int, stage: str, cfg: RasterConfig,
                  return_decomposition: bool = True
                  ) -> Dict[str, List[torch.Tensor]]:
    """Render every camera of a split.  Returns lists, one entry per
    camera: ``rgbs`` [H,W,3], ``depths`` [H,W] and, with the
    decomposition, ``dynamic_rgbs``/``static_rgbs`` [H,W,3]."""
    out: Dict[str, List[torch.Tensor]] = {
        "rgbs": [], "depths": [], "dynamic_rgbs": [], "static_rgbs": []}
    for cam in cameras:
        pkg = render(cam, pool, deform, pipe, bg, aabb, active_sh_degree,
                     stage=stage, return_decomposition=return_decomposition,
                     cfg=cfg)
        out["rgbs"].append(_frame(pkg["render"]))
        out["depths"].append(pkg["depth"])
        if "render_d" in pkg:
            out["dynamic_rgbs"].append(_frame(pkg["render_d"]))
            out["static_rgbs"].append(_frame(pkg["render_s"]))
    return {k: v for k, v in out.items() if v}
