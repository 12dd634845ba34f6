# Frozen copy of s3gaussian_tpu_torch/train/lr.py at commit 0fe8bd83fbe2d3b430992244fdc79098999720ec, imports
# rewritten to benchmark.frozen.ref: part of the benchmark's plain reference.
"""Learning-rate schedule (port of ``s3gaussian_tpu/train/lr.py``).

Parity: ``get_expon_lr_func`` (reference utils/general_utils.py:196-229):
log-linear interpolation between lr_init and lr_final over max_steps,
with an optional sine-eased delay multiplier.  A function of a step
tensor, evaluated on its device, so a train step needs no host sync.
"""

from __future__ import annotations

import math

import torch


def expon_lr(step: torch.Tensor, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t)
                         + math.log(lr_final) * t)
    return torch.where(step < 0, 0.0, delay_rate * log_lerp)
