"""pool_init_s.train: seconds of set-up in the ``pool.init`` host span,
the pool built from the point cloud (``models/pool.py::create_from_pcd``:
the host KNN of its ``pool.knn`` child, the host arrays, their copy to
the card)."""

from benchmark.metrics._span_record import host_s


def read(ctx):
    return host_s(ctx, ("pool.init",))
