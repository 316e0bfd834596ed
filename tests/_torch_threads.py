"""One torch thread for the test modules that import ``torch_threads``.

The driver runs the suite as ``pytest -n 6``: six workers on one host, each
with torch's default of one intra-op thread per core. The port's eager
forwards at test size are many small ops, each a parallel region, and
with six pools on the same cores their threads mostly wait for one
another: one stream test took 291 s in such a run and 6 s alone. A module
that imports this fixture runs its tests with one torch thread and gives
the worker its thread count back when it ends, so the modules that run
after it in the same worker are not affected. Results do not depend on
it: the comparisons are against the JAX package or within one process.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
