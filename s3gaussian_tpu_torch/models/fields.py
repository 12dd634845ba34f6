"""The deformation field a run trains, built from its ``FieldParams``:
the one factory behind the training CLI, checkpoint resume, the sweep,
the offline tools and the benchmark's program builder."""

from __future__ import annotations

from typing import Union

import torch

from s3gaussian_tpu_torch.config import FieldParams, ModelHiddenParams
from s3gaussian_tpu_torch.models.deform_mlp import DeformMLP
from s3gaussian_tpu_torch.models.deformation import DeformationField

# any field: the renderer, the train step and the sweep take each alike
Field = Union[DeformationField, DeformMLP]


def build_field(hp: ModelHiddenParams, fp: FieldParams,
                generator: torch.Generator,
                device: torch.device | str) -> Field:
    """The field ``fp.field_kind`` names, its weights drawn from
    ``generator``: the hexplane field of ``hp``, or Deformable 3D
    Gaussians' MLP at ``fp``'s widths."""
    if fp.field_kind == "hexplane":
        return DeformationField(hp, generator, device)
    if fp.field_kind == "deformable3dgs":
        return DeformMLP(fp, generator, device)
    raise ValueError(f"unknown field_kind {fp.field_kind!r}: hexplane or "
                     f"deformable3dgs")
