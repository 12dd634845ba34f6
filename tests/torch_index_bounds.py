"""A dispatch mode that records the range of every integer index tensor the
indexing operators receive (jax-free, so the card's tests use it too).

On the CPU an index out of range raises; on CUDA it trips a device-side
assert that ends the process's CUDA context.  Density control must never
hand an indexing operator the JAX package's dropped sentinel ``Nc``.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_",
            "index_select", "index_copy", "index_copy_", "index_add",
            "index_add_", "index_fill", "index_fill_", "gather", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_", "take", "take_along_dim", "embedding"}


class IndexBounds(TorchDispatchMode):
    """``ranges`` lists (operator, min, max) of each integer index."""

    def __init__(self):
        super().__init__()
        self.ranges = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in INDEXING:
            for t in tree_leaves((args[1:], kwargs)):
                if (isinstance(t, torch.Tensor) and t.numel()
                        and not t.dtype.is_floating_point
                        and t.dtype != torch.bool):
                    self.ranges.append((name, int(t.min()), int(t.max())))
        return func(*args, **kwargs)

    def assert_within(self, n: int) -> None:
        assert self.ranges, "no indexing operator ran"
        bad = [r for r in self.ranges if r[1] < 0 or r[2] >= n]
        assert not bad, bad
