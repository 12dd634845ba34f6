"""A configuration's deformation field, resolved by name: the port's
builder, the plain reference's builder and one row's forward operations.

A configuration file may carry a top-level ``"field"``::

    "field": {"program": "module:callable", "reference": "module:callable",
              "work": "module:callable", "params": {...}}

``program`` builds the port's field and ``reference`` the plain float32
one (kept under ``benchmark/``; it imports ``benchmark.frozen.ref`` at
most, nothing of the port or the JAX package).  Both are called as
``build(hp, params, generator, device)``, ``hp`` the side's own
``ModelHiddenParams`` of ``"model"`` (which still sets the loss's
switches: a field without a grid sets the hexplane weights to 0), and
return a module with ``DeformationField``'s contract: ``forward(xyz,
scales, rotations, opacity, shs, t, aabb) -> DeformOut`` on raw
attributes, ``param_groups()`` with the grid's parameters named
``grid.``, and ``named_parameters()`` / ``state_dict()`` of the same
names and shapes on both sides, drawn from ``generator`` in the same
order.  ``work(model, params)`` gives one row's forward operations in
``flops.py``'s conventions.  Without ``"field"``, the hexplane field of
``"model"``: the port's ``DeformationField``, its frozen copy and
``flops.field_forward``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

import torch

KEYS = ("program", "reference", "work", "params")
HEXPLANE = {"program": "benchmark.frozen.fields:hexplane_program",
            "reference": "benchmark.frozen.fields:hexplane_reference",
            "work": "benchmark.frozen.fields:hexplane_work", "params": {}}


def hexplane_program(hp, params: Dict, generator: torch.Generator, device):
    from s3gaussian_tpu_torch.models.deformation import DeformationField
    return DeformationField(hp, generator, device)


def hexplane_reference(hp, params: Dict, generator: torch.Generator,
                       device):
    from benchmark.frozen.ref.models.deformation import DeformationField
    return DeformationField(hp, generator, device)


def hexplane_work(model: Dict, params: Dict) -> int:
    from benchmark.frozen.flops import field_forward
    return field_forward(model)


def entry(config: Dict) -> Dict:
    """The configuration's ``"field"``, or the hexplane field's."""
    field = config.get("field", HEXPLANE)
    missing = set(KEYS) - set(field)
    if missing:
        raise KeyError(f"the configuration's field lacks {sorted(missing)}")
    return field


def _named(config: Dict, role: str) -> Tuple[Callable, Dict]:
    """The callable that the field names for ``role``, and its params."""
    field = entry(config)
    module, _, name = field[role].partition(":")
    return getattr(importlib.import_module(module), name), field["params"]


def program(config: Dict, hp, generator: torch.Generator, device):
    """The port's field of ``config``."""
    build, params = _named(config, "program")
    return build(hp, params, generator, device)


def reference(config: Dict, hp, generator: torch.Generator, device):
    """The plain reference's field of ``config``."""
    build, params = _named(config, "reference")
    return build(hp, params, generator, device)


def row_ops(config: Dict) -> int:
    """Operations of one row through the field's forward."""
    work, params = _named(config, "work")
    return int(work(config["model"], params))
