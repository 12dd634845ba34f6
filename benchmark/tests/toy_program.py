"""The program side of a toy gridless deformation field, built as the
port builds its layers: a configuration's ``"field"`` names ``build``.

The field encodes the detached positions and the time with sines and
cosines at ``xyz_freqs`` and ``t_freqs`` octaves (the input kept beside
them), runs Linear(in, W), ReLU, the encoding concatenated again,
Linear(W + in, W), ReLU, and a head Linear(W, 3) whose output is added
to the positions.  Its parameters are drawn from the generator in the
order l0, l1, dx (each weight, then its bias).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from s3gaussian_tpu_torch.models.deformation import DeformOut, _linear


def encode(p: torch.Tensor, n_freqs: int) -> torch.Tensor:
    return torch.cat([p] + [f(2.0 ** k * p) for k in range(n_freqs)
                            for f in (torch.sin, torch.cos)], dim=-1)


class ToyField(nn.Module):
    def __init__(self, params: Dict, generator: torch.Generator, device):
        super().__init__()
        self.params = params
        w = params["width"]
        n_in = 3 * (1 + 2 * params["xyz_freqs"]) + 1 + 2 * params["t_freqs"]
        self.l0 = _linear(n_in, w, generator, device)
        self.l1 = _linear(w + n_in, w, generator, device)
        self.dx = _linear(w, 3, generator, device)

    def param_groups(self):
        return {"grid": {}, "deformation": dict(self.named_parameters())}

    def skip(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([h, x], dim=-1)

    def forward(self, xyz, scales, rotations, opacity, shs, t, aabb):
        n = xyz.shape[0]
        x = torch.cat([encode(xyz.detach(), self.params["xyz_freqs"]),
                       encode(t.reshape(-1, 1).expand(n, 1),
                              self.params["t_freqs"])], dim=-1)
        h = torch.relu(self.l0(x))
        h = torch.relu(self.l1(self.skip(h, x)))
        dx = self.dx(h)
        return DeformOut(xyz + dx, scales, rotations, opacity, shs, dx,
                         None, None)


def build(hp, params: Dict, generator: torch.Generator, device) -> ToyField:
    return ToyField(params, generator, device)
