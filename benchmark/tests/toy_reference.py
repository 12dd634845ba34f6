"""The plain reference of the toy gridless field of ``toy_program.py``
and its work count, written apart from it: explicit products and sums
on parameters named and drawn as the program's."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.frozen.flops import linear
from benchmark.frozen.ref.models.deformation import DeformOut


def n_inputs(params: Dict) -> int:
    return 3 * (1 + 2 * params["xyz_freqs"]) + 1 + 2 * params["t_freqs"]


class Affine(nn.Module):
    """y = x wᵀ + b, xavier-uniform w and U(±1/√fan_in) b from the
    generator, weight first."""

    def __init__(self, n_in: int, n_out: int, generator, device):
        super().__init__()
        a = math.sqrt(6.0 / (n_in + n_out))
        w = (2 * torch.rand(n_out, n_in, generator=generator) - 1) * a
        b = (2 * torch.rand(n_out, generator=generator) - 1) * (
            1.0 / math.sqrt(n_in))
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(b.to(device))

    def forward(self, x):
        return x @ self.weight.t() + self.bias


def _encode(p: torch.Tensor, n_freqs: int) -> torch.Tensor:
    parts = [p]
    for k in range(n_freqs):
        parts += [torch.sin(p * 2.0 ** k), torch.cos(p * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


class ToyReference(nn.Module):
    def __init__(self, params: Dict, generator, device):
        super().__init__()
        self.params = params
        w, n_in = params["width"], n_inputs(params)
        self.l0 = Affine(n_in, w, generator, device)
        self.l1 = Affine(w + n_in, w, generator, device)
        self.dx = Affine(w, 3, generator, device)

    def param_groups(self):
        return {"grid": {}, "deformation": dict(self.named_parameters())}

    def forward(self, xyz, scales, rotations, opacity, shs, t, aabb):
        p = self.params
        tt = t.reshape(-1, 1).expand(xyz.shape[0], 1)
        x = torch.cat([_encode(xyz.detach(), p["xyz_freqs"]),
                       _encode(tt, p["t_freqs"])], dim=-1)
        h = torch.clamp(self.l0(x), min=0.0)
        h = torch.clamp(self.l1(torch.cat([h, x], dim=-1)), min=0.0)
        dx = self.dx(h)
        return DeformOut(xyz + dx, scales, rotations, opacity, shs, dx,
                         None, None)


def build(hp, params: Dict, generator, device) -> ToyReference:
    return ToyReference(params, generator, device)


def row_ops(model: Dict, params: Dict) -> int:
    """One row's forward: a multiply, a sine and a cosine an octave a
    coordinate, the three Linears and the residual add of dx."""
    w, n_in = params["width"], n_inputs(params)
    encoding = 3 * (3 * params["xyz_freqs"] + params["t_freqs"])
    return (encoding + linear(n_in, w) + linear(w + n_in, w)
            + linear(w, 3) + 3)
