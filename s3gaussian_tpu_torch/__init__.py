"""PyTorch / CUDA port of ``s3gaussian_tpu`` (the JAX package stays the
reference every module here is held against).

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``s3gaussian_tpu``: it keeps its own copy of what it needs (the config
dataclasses, the native KNN loader).  Its entry points put tensors on the
card unless the caller asks for the CPU.  Like the JAX package's
``__init__`` this file imports nothing, so importing a submodule pulls in
only what it needs.
"""
