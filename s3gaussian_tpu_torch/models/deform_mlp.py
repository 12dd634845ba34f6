"""Deformable 3D Gaussians' deformation network (Yang et al., CVPR 2024,
https://github.com/ingra14m/Deformable-3D-Gaussians,
``utils/time_utils.py::DeformNetwork`` outside Blender scenes, without
its 6-DoF warp), with ``DeformationField``'s contract: ``forward(xyz,
scales, rotations, opacity, shs, t, aabb) -> DeformOut`` and
``param_groups()``.

    x = [γ(xyz.detach()), γ(t)]          γ(p) = [p, sin(2⁰p), cos(2⁰p), …,
                                                  sin(2ᴸ⁻¹p), cos(2ᴸ⁻¹p)]
    h = ReLU(linear[i](h)) for i < D,   h = cat(x, h) after linear[skip]
    d_xyz, d_rotation, d_scaling = gaussian_warp(h), gaussian_rotation(h),
                                   gaussian_scaling(h)

With L = ``field_multires`` (10: 63 inputs) for the position and
``field_t_multires`` (10: 21) for the time, D = ``field_depth`` (8), W =
``field_width`` (256), skip ``field_skip`` (4: ``linear[5]`` is
Linear(W + 84, W)).  The deltas are added after activation, as
Deformable-3DGS's renderer adds them: the position's to the raw
position (``DeformOut.xyz``), the scaling's to exp(scaling) and the
rotation's to the normalised quaternion (``DeformOut.d_scales`` and
``d_rotations``, which ``render/renderer.py::_attributes`` adds).  A
scale exp(s) + d may be negative: the projection uses its square.
Opacity and SH are not deformed.  The renderer's projection normalises
the deformed quaternion, where Deformable-3DGS hands it unnormalised to
its rasterizer: the rotation's delta turns the rotation only.

Init is ``nn.Linear``'s default, weight and bias each U(±1/√fan_in),
drawn from the caller's generator in construction order (``linear[0]``
… ``linear[D-1]``, then warp, rotation, scaling; each weight before its
bias).  Every parameter falls in the ``deformation`` group (no grid).

Inside a train step the inner span ``field.mlp.fwd`` opens after the
encoding; ``field.mlp.bwd`` opens with ``field.bwd`` and closes when the
first Linear's output has its gradient.  The encoding needs no gradient,
so the first Linear's weight product (its only backward product) falls
after that close, in ``field.bwd``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from s3gaussian_tpu_torch.config import FieldParams
from s3gaussian_tpu_torch.models.deformation import DeformOut
from s3gaussian_tpu_torch.utils import spans


def encode(p: torch.Tensor, octaves: int) -> torch.Tensor:
    """γ(p): p, then sin and cos of 2^k·p for k < ``octaves``."""
    parts = [p]
    for k in range(octaves):
        parts += [torch.sin(p * 2.0 ** k), torch.cos(p * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def _default_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                    device) -> nn.Linear:
    """``nn.Linear``'s default init, U(±1/√fan_in) weight then bias,
    from ``generator``."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.copy_((2 * torch.rand(fan_out, fan_in,
                                         generator=generator) - 1) * bound)
        lin.bias.copy_((2 * torch.rand(fan_out, generator=generator) - 1)
                       * bound)
    return lin.to(device)


class DeformMLP(nn.Module):
    """Deformable 3D Gaussians' ``DeformNetwork`` on raw attributes."""

    kind = "deformable3dgs"

    def __init__(self, fp: FieldParams, generator: torch.Generator,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.fp = fp
        w = fp.field_width
        n_in = 3 * (1 + 2 * fp.field_multires) + 1 + 2 * fp.field_t_multires
        self.linear = nn.ModuleList(
            [_default_linear(n_in, w, generator, device)]
            + [_default_linear(w + n_in if i == fp.field_skip else w, w,
                               generator, device)
               for i in range(fp.field_depth - 1)])
        self.gaussian_warp = _default_linear(w, 3, generator, device)
        self.gaussian_rotation = _default_linear(w, 4, generator, device)
        self.gaussian_scaling = _default_linear(w, 3, generator, device)

    def param_groups(self) -> dict[str, dict[str, nn.Parameter]]:
        return {"grid": {}, "deformation": dict(self.named_parameters())}

    def embed(self, xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The network's input [N, 84]: γ of the detached positions, and
        γ of the time (a 0-d tensor, or [N, 1]) on every row."""
        xyz = xyz.detach()
        t = t.reshape(-1, 1).expand(xyz.shape[0], 1)
        return torch.cat([encode(xyz, self.fp.field_multires),
                          encode(t, self.fp.field_t_multires)], dim=-1)

    def skip(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The input concatenated before ``h``, after ``linear[skip]``."""
        return torch.cat([x, h], dim=-1)

    def forward(self, xyz: torch.Tensor, scales: torch.Tensor,
                rotations: torch.Tensor, opacity: torch.Tensor,
                shs: torch.Tensor, t: torch.Tensor,
                aabb: Optional[torch.Tensor]) -> DeformOut:
        x = self.embed(xyz, t)
        spans.inner_mark("field.mlp.fwd")
        h = x
        for i, lin in enumerate(self.linear):
            h = lin(h)
            if i == 0:
                (h,) = spans.grad_inner_mark("field.mlp.bwd", h)
            h = torch.relu(h)
            if i == self.fp.field_skip:
                h = self.skip(h, x)
        dx = self.gaussian_warp(h)
        return DeformOut(xyz + dx, scales, rotations, opacity, shs, dx,
                         None, None, d_scales=self.gaussian_scaling(h),
                         d_rotations=self.gaussian_rotation(h))
