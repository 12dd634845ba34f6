"""One intra-op thread for torch while a port test module runs.

The suite runs in several pytest-xdist workers that share the machine's
cores.  The port's CPU tests launch thousands of operators on tiny
tensors, and torch's default of one thread per core turns each into a
parallel region whose threads wait on one another; with the cores
oversubscribed that waiting dominates (a CLI run over the Waymo fixture
took 20x longer with busy neighbours than with one thread).  Import the
fixture into a test module to run it with one thread:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
