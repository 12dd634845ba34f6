"""Per-group Adam as plain functions over dicts of tensors (port of
``s3gaussian_tpu/train/optim.py``).

The reference uses one torch Adam with eight named param groups at
(scheduled) learning rates and eps 1e-15 (gaussian_model.py:170-201).
Here, as in the JAX package, the state is explicit: ``mu``/``nu`` mirror
the parameter dict ``{"pool": {...}, "deform": {...}}`` and ``count`` is
global, so density control can edit rows of the moments and the NaN
watchdog can zero a learning rate on the device without a host sync.
Learning rates are 0-d device tensors, one per group.  The update is in
place, count included, with ``torch._foreach_*`` over all tensors at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

B1, B2 = 0.9, 0.999
EPS = 1e-15

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass
class AdamState:
    mu: Params
    nu: Params
    count: torch.Tensor   # [] int32


def init_adam(params: Params) -> AdamState:
    def zeros() -> Params:
        return {g: {k: torch.zeros_like(v) for k, v in d.items()}
                for g, d in params.items()}

    dev = next(iter(params["pool"].values())).device
    return AdamState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def path_group(group: str, name: str) -> str:
    """The reference param-group name of a parameter: the pool's keys are
    group names (xyz, f_dc, f_rest, opacity, scaling, rotation); in the
    deformation field the hexplane is ``grid`` and the rest
    ``deformation`` (gaussian_model.py:176-185)."""
    if group == "pool":
        return name
    if group == "deform":
        return "grid" if name.startswith("grid.") else "deformation"
    raise KeyError(f"unknown param group {group}")


def _flat(tree: Params, like: Params) -> List[torch.Tensor]:
    """The tensors of ``tree`` in the key order of ``like``."""
    return [tree[g][k] for g, d in like.items() for k in d]


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState,
                lr_for: Callable[[str, str], torch.Tensor]) -> AdamState:
    """One Adam step, in place on ``params``, the moments and ``count``.
    ``lr_for(group, name)`` gives each tensor its group's learning rate
    (a 0-d tensor on the parameters' device)."""
    state.count.add_(1)
    cf = state.count.to(torch.float32)
    c1 = 1 - torch.pow(B1, cf)
    c2 = 1 - torch.pow(B2, cf)
    p, g = _flat(params, params), _flat(grads, params)
    mu, nu = _flat(state.mu, params), _flat(state.nu, params)
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - B2))
    mhat = torch._foreach_div(mu, c1)
    vhat = torch._foreach_div(nu, c2)
    denom = torch._foreach_add(torch._foreach_sqrt(vhat), EPS)
    lrs = [lr_for(grp, name) for grp, d in params.items() for name in d]
    step = torch._foreach_mul(torch._foreach_div(mhat, denom), lrs)
    torch._foreach_sub_(p, step)
    return state
