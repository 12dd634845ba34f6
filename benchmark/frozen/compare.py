"""The comparison that decides ``correct`` in a training cell.

Each side (the program, the plain reference) gives, for the first three
steps of a run: each step's loss; the norm of each leaf's first
gradient as Adam got it, worked out from the first moment after one
step (m1 = (1 - B1) g); and the norm of each leaf's change over the
three steps.  A gap of norms is |program - reference| over the larger of
the reference's norm of that leaf and the median leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change.

The loss compared is the first step's, where both sides start from the
same state.  From the second step on the two sides' parameters differ by
rounding, and the renderer is not continuous in them: a Gaussian whose
footprint is capped to a rectangle of tiles moves that rectangle by a
whole tile when its projected centre crosses a tile's edge, and changes
thousands of pixels at once.  The later steps' losses are returned for
the log (``later_loss_gaps``), not compared; the change over the three
steps is.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import torch

B1 = 0.9
STILL_SHARE = 1e-3


def leaves(pool_params: Dict[str, torch.Tensor],
           field: Iterable[Tuple[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    """The trainable tensors by name: ``pool.<name>``, ``field.<name>``."""
    out = {f"pool.{k}": v for k, v in pool_params.items()}
    out.update({f"field.{k}": v for k, v in field})
    return out


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def first_grad_norms(mu: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's first gradient's norm from its first moment after one
    step."""
    return {k: norm(v) / (1.0 - B1) for k, v in mu.items()}


def change_norms(before: Dict[str, torch.Tensor],
                 after: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of change, on the host in float64."""
    return {k: norm(after[k].detach().cpu().double()
                    - before[k].detach().cpu().double()) for k in before}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap of norms and its name."""
    med = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g >= worst:
            worst, which = g, k
    return worst, which


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """{number: {"value", "leaf"}} of the three compared numbers."""
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) != len(lr):
        raise ValueError(f"{len(lp)} program losses against {len(lr)}")
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    names = sorted(ref["grad"])
    grad, g_leaf = norm_gap(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad"][k] for k in names)
    moved = [k for k in names if ref["grad"][k] >= STILL_SHARE * med]
    delta, d_leaf = norm_gap(prog["delta"], ref["delta"], moved)
    return {"loss_gap": {"value": gaps[0], "leaf": ""},
            "grad_gap": {"value": grad, "leaf": g_leaf},
            "delta_gap": {"value": delta, "leaf": d_leaf},
            "still_leaves": sorted(set(names) - set(moved)),
            "later_loss_gaps": gaps[1:]}
