"""The program side of Deformable 3D Gaussians' deformation field, as a
configuration's ``"field"`` names it (``benchmark/frozen/fields.py``):
the port's own factory, which the training CLI calls, on the
configuration's ``"params"`` (the port's ``FieldParams``)."""

from __future__ import annotations

from typing import Dict

import torch


def program(hp, params: Dict, generator: torch.Generator, device):
    from s3gaussian_tpu_torch.config import FieldParams
    from s3gaussian_tpu_torch.models.fields import build_field
    return build_field(hp, FieldParams(**params), generator, device)
