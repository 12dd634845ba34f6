"""Device selection for the port."""

from __future__ import annotations

import torch


def configure_device(device: str = "cuda") -> torch.device:
    """Return ``torch.device(device)`` with float32 numerics pinned.

    TF32 is switched off for both matmuls and cuDNN: the JAX reference
    computes these products in full float32 (``Precision.HIGHEST`` in the
    compositor, f32 MLPs), and TF32 keeps only ~3 decimal digits, which
    would move the port outside the parity tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev
