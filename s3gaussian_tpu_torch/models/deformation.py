"""Deformation field: hexplane encoder + multi-head MLP decoder, as an
``nn.Module`` (port of ``s3gaussian_tpu/models/deformation.py``),
trainable end to end.

Heads are ReLU → Linear(W,W) → ReLU → Linear(W,out) for dx(3), ds(3),
dr(4), do(1), dshs(48), gated by ``no_dx``/``no_ds``/``no_dr``/``no_do``/
``no_dshs``; the DINO feature head is Linear(W,64) → ReLU → Linear(64,64)
→ ReLU → Linear(64,3).  Init is the reference's: xavier-uniform weights,
torch-default U(±1/√fan_in) biases, every draw from the caller's
``torch.Generator``.  Layers are ``nn.Linear`` (weight [out, in]); the
JAX package stores ``w`` as [in, out] and computes ``x @ w + b``, so
``weights.deformation_from_numpy`` transposes on load.  Inside a train
step the decoder (everything after the hexplane query) is timed by the
inner spans ``field.mlp.fwd`` and ``field.mlp.bwd`` (``utils/spans.py``).

``param_groups`` splits the parameters into the reference's two
optimizer groups: ``grid`` (the hexplane planes) and ``deformation``
(everything else), as ``s3gaussian_tpu/train/optim.py:72-86`` maps them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from s3gaussian_tpu_torch.config import ModelHiddenParams
from s3gaussian_tpu_torch.models import hexplane as hx
from s3gaussian_tpu_torch.ops.gridsample import grid_sample_3d
from s3gaussian_tpu_torch.ops.transforms import quat_multiply
from s3gaussian_tpu_torch.utils import spans


def _linear(fan_in: int, fan_out: int, generator: torch.Generator,
            device) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    bb = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.copy_((2 * torch.rand(fan_out, fan_in, generator=generator)
                          - 1) * a)
        lin.bias.copy_((2 * torch.rand(fan_out, generator=generator) - 1) * bb)
    return lin.to(device)


def _head(width: int, out: int, generator, device) -> nn.Sequential:
    return nn.Sequential(nn.ReLU(), _linear(width, width, generator, device),
                         nn.ReLU(), _linear(width, out, generator, device))


class DeformOut(NamedTuple):
    """A field's raw (pre-activation) attributes; ``d_scales`` and
    ``d_rotations``, where a field gives them, are deltas in activated
    space that the renderer adds after exp and normalisation."""
    xyz: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    opacity: torch.Tensor
    shs: torch.Tensor
    dx: Optional[torch.Tensor]
    feat: Optional[torch.Tensor]
    dshs: Optional[torch.Tensor]
    d_scales: Optional[torch.Tensor] = None
    d_rotations: Optional[torch.Tensor] = None


class DeformationField(nn.Module):
    """``forward_dynamic`` of the reference on raw (pre-activation)
    attributes."""

    kind = "hexplane"

    def __init__(self, hp: ModelHiddenParams, generator: torch.Generator,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.hp = hp
        w = hp.net_width
        out_dim = hp.kplanes_config["output_coordinate_dim"]
        self.n_scales = len(hp.multires)
        self.grid = hx.init_hexplane(generator, out_dim,
                                     hp.kplanes_config["resolution"],
                                     hp.multires, device)
        # feature_out: Linear(gfeat, W) + (D-1)x[ReLU, Linear(W,W)]
        layers = [_linear(out_dim * self.n_scales, w, generator, device)]
        for _ in range(hp.defor_depth - 1):
            layers += [nn.ReLU(), _linear(w, w, generator, device)]
        self.feature_out = nn.Sequential(*layers)
        heads = {"pos": (hp.no_dx, 3), "scales": (hp.no_ds, 3),
                 "rotations": (hp.no_dr, 4), "opacity": (hp.no_do, 1),
                 "shs": (hp.no_dshs, 16 * 3),
                 "static_mlp": (not hp.static_mlp, 1)}
        self.heads = nn.ModuleDict({
            name: _head(w, out, generator, device)
            for name, (off, out) in heads.items() if not off})
        self.dino = (nn.Sequential(_linear(w, 64, generator, device), nn.ReLU(),
                                   _linear(64, 64, generator, device), nn.ReLU(),
                                   _linear(64, 3, generator, device))
                     if hp.feat_head else None)
        # DenseGrid(channels=1, world_size=[64,64,64]) init to ones
        self.empty_voxel = (nn.Parameter(torch.ones(1, 64, 64, 64,
                                                    device=device))
                            if hp.empty_voxel else None)

    def param_groups(self) -> dict[str, dict[str, nn.Parameter]]:
        """{"grid": {name: p}, "deformation": {name: p}} over
        ``named_parameters()`` names."""
        groups: dict[str, dict[str, nn.Parameter]] = {"grid": {},
                                                       "deformation": {}}
        for name, p in self.named_parameters():
            groups["grid" if name.startswith("grid.")
                   else "deformation"][name] = p
        return groups

    def forward(self, xyz: torch.Tensor, scales: torch.Tensor,
                rotations: torch.Tensor, opacity: torch.Tensor,
                shs: torch.Tensor, t: torch.Tensor,
                aabb: torch.Tensor) -> DeformOut:
        """t is [N,1] in [0,1] or a 0-d tensor (one time for all points)."""
        hp = self.hp
        h = hx.query_hexplane(
            self.grid, xyz, t, aabb, self.n_scales,
            compute_dtype=torch.bfloat16 if hp.grid_compute_bf16 else None)
        # the decoder's inner spans (inside a train step): from here to the
        # step's next mark, and in the backward from the field's outputs'
        # gradients to h's
        (h,) = spans.grad_inner_mark("field.mlp.bwd", h)
        spans.inner_mark("field.mlp.fwd")
        h = self.feature_out(h)

        # static/dynamic gate multiplying the undeformed attribute before
        # the delta is added (attr*mask + d_attr); identity by default
        if hp.static_mlp:
            mask = self.heads["static_mlp"](h)
        elif hp.empty_voxel:
            # coords normalized by the [max; min] aabb and flipped to
            # (z, y, x) like the reference's .flip(-1)
            norm = (xyz - aabb[1]) / (aabb[0] - aabb[1]) * 2.0 - 1.0
            mask = grid_sample_3d(self.empty_voxel, norm.flip(-1))
        else:
            mask = None

        def gated(attr):
            return attr if mask is None else attr * mask

        dx = feat = dshs = None
        out_xyz, out_scales, out_rot, out_op, out_shs = (xyz, scales,
                                                         rotations, opacity,
                                                         shs)
        if not hp.no_dx:
            dx = self.heads["pos"](h)
            out_xyz = gated(xyz) + dx
        if not hp.no_ds:
            out_scales = gated(scales) + self.heads["scales"](h)
        if not hp.no_dr:
            # rotations are never masked
            dr = self.heads["rotations"](h)
            out_rot = (quat_multiply(rotations, dr) if hp.apply_rotation
                       else rotations + dr)
        if not hp.no_do:
            out_op = gated(opacity) + self.heads["opacity"](h)
        if not hp.no_dshs:
            dshs = self.heads["shs"](h).reshape(shs.shape[0], 16, 3)
            out_shs = (shs if mask is None else shs * mask[:, :, None]) + dshs
        if self.dino is not None:
            feat = self.dino(h)
        return DeformOut(out_xyz, out_scales, out_rot, out_op, out_shs,
                         dx, feat, dshs)
