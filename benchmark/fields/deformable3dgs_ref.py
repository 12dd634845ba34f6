"""The plain float32 reference of Deformable 3D Gaussians' deformation
network (Yang et al., CVPR 2024, github.com/ingra14m/Deformable-3D-
Gaussians ``utils/time_utils.py::DeformNetwork``, ``is_blender`` and
``is_6dof`` False; the deltas as its ``gaussian_renderer/__init__.py::
render`` applies them), written apart from the port, and its work: a
row's forward operations in ``benchmark/frozen/flops.py``'s conventions,
the bytes a row moves through its Linears and the bytes of their
weights.

Parameters are named, shaped and drawn as the program's: ``linear.0`` …
``linear.{D-1}``, then ``gaussian_warp``, ``gaussian_rotation``,
``gaussian_scaling``, each weight then its bias, U(±1/√fan_in) from the
generator.  ``params`` holds the widths as the port's ``FieldParams``
names them (``field_depth``, ``field_width``, ``field_multires``,
``field_t_multires``, ``field_skip``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.frozen.flops import linear
from benchmark.frozen.ref.models.deformation import DeformOut

# float32's smallest normal: the floor of |exp(s) + d_scaling| before its
# log, so that a scale that sums to 0 gives a finite raw scale
FLOAT32_TINY = torch.finfo(torch.float32).tiny


def n_inputs(params: Dict) -> int:
    """The network's input width: γ(xyz) and γ(t)."""
    return (3 * (1 + 2 * params["field_multires"]) + 1
            + 2 * params["field_t_multires"])


def linears(params: Dict) -> List[Tuple[int, int]]:
    """(inputs, outputs) of every Linear, in order: the trunk, Linear(W +
    input, W) after the skip, and the three heads."""
    w, n_in = params["field_width"], n_inputs(params)
    trunk = [(n_in, w)] + [(w + n_in if i == params["field_skip"] else w, w)
                           for i in range(params["field_depth"] - 1)]
    return trunk + [(w, 3), (w, 4), (w, 3)]


class Affine(nn.Module):
    """y = x wᵀ + b, w and b each U(±1/√fan_in) from the generator,
    weight first (``nn.Linear``'s default init)."""

    def __init__(self, n_in: int, n_out: int, generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(n_in)
        w = (2 * torch.rand(n_out, n_in, generator=generator) - 1) * bound
        b = (2 * torch.rand(n_out, generator=generator) - 1) * bound
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(b.to(device))

    def forward(self, x):
        return x @ self.weight.t() + self.bias


def _embed(p: torch.Tensor, octaves: int) -> torch.Tensor:
    """Deformable-3DGS's ``Embedder``: p, sin(2^k p), cos(2^k p)."""
    out = [p]
    for freq in 2.0 ** torch.linspace(0.0, octaves - 1, octaves):
        out += [torch.sin(p * freq), torch.cos(p * freq)]
    return torch.cat(out, dim=-1)


class Deformable3DGSReference(nn.Module):
    def __init__(self, params: Dict, generator, device):
        super().__init__()
        self.params = params
        shapes = linears(params)
        self.linear = nn.ModuleList([Affine(i, o, generator, device)
                                     for i, o in shapes[:-3]])
        self.gaussian_warp = Affine(*shapes[-3], generator, device)
        self.gaussian_rotation = Affine(*shapes[-2], generator, device)
        self.gaussian_scaling = Affine(*shapes[-1], generator, device)

    def param_groups(self):
        return {"grid": {}, "deformation": dict(self.named_parameters())}

    def forward(self, xyz, scales, rotations, opacity, shs, t, aabb):
        p = self.params
        time = t.reshape(-1, 1).expand(xyz.shape[0], 1)
        x_emb = _embed(xyz.detach(), p["field_multires"])
        t_emb = _embed(time, p["field_t_multires"])
        h = torch.cat([x_emb, t_emb], dim=-1)
        for i, layer in enumerate(self.linear):
            h = torch.clamp(layer(h), min=0.0)
            if i == p["field_skip"]:
                h = torch.cat([x_emb, t_emb, h], dim=-1)
        d_xyz = self.gaussian_warp(h)
        d_rotation = self.gaussian_rotation(h)
        d_scaling = self.gaussian_scaling(h)
        # The frozen renderer takes raw attributes and activates them
        # (exp, normalisation).  The scale exp(s) + d_scaling may be
        # negative, so it goes as log|exp(s) + d_scaling|: its exp is the
        # magnitude, and the covariance takes the scale's square, so the
        # render and every gradient equal those of the signed sum.
        scale = torch.exp(scales) + d_scaling
        raw_scale = torch.log(torch.clamp(torch.abs(scale),
                                          min=FLOAT32_TINY))
        # normalize(r) + d_rotation goes as is: the renderer's
        # normalisation of it is the projection's own
        q = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
        return DeformOut(xyz + d_xyz, raw_scale, q + d_rotation, opacity,
                         shs, d_xyz, None, None)


def build(hp, params: Dict, generator, device) -> Deformable3DGSReference:
    return Deformable3DGSReference(params, generator, device)


def row_ops(model: Dict, params: Dict) -> int:
    """One row's forward: the encoding (a multiply, a sine and a cosine an
    octave a coordinate, time included), the Linears (ReLUs and the
    concatenation none) and the deltas' adds (3 position, 3 scale, 4
    rotation)."""
    encoding = 3 * (3 * params["field_multires"]
                    + params["field_t_multires"])
    return (encoding + sum(linear(i, o) for i, o in linears(params))
            + 3 + 3 + 4)


def row_bytes(model: Dict, params: Dict) -> int:
    """Bytes one row moves through the Linears in the forward: each
    Linear's input read and output written once, float32."""
    return sum(4 * (i + o) for i, o in linears(params))


def weight_bytes(model: Dict, params: Dict) -> int:
    """Bytes of the Linears' weights and biases, float32."""
    return sum(4 * (i * o + o) for i, o in linears(params))
