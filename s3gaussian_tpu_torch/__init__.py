"""PyTorch / CUDA port of ``s3gaussian_tpu`` (the JAX package stays the
reference every module here is held against).

The package imports ``torch``, ``numpy`` and the two jax-free modules of
the JAX package (``s3gaussian_tpu.config``, ``s3gaussian_tpu.native``);
never ``jax``.  Like the JAX package's ``__init__`` this file imports
nothing, so importing a submodule pulls in only what it needs.
"""
