"""The port reads the same config dataclasses as the JAX package.

``s3gaussian_tpu.config`` imports no jax (``s3gaussian_tpu/__init__.py``
is empty), so both packages share one definition of every flag; this
module re-exports the ones the port's render path consumes.
"""

from s3gaussian_tpu.config import (ModelHiddenParams, PipelineParams,
                                   RasterConfig)

__all__ = ["ModelHiddenParams", "PipelineParams", "RasterConfig"]
