"""One torch thread per test module of the port.

The tier-1 run spreads the test files over several workers on one
machine. The port's tests run thousands of small torch ops per stage, and
with torch's default intra-op pool (one thread per core in every worker)
the workers spend their time contending for the cores: the batched-replay
file took 1280 s that way and 137 s with one thread. Every
`tests/test_torch_*.py` that runs torch stages imports `one_torch_thread`,
a module-scoped autouse fixture that pins torch to one thread for the
module and restores the old count after it:

    from tests.test_torch_threads import one_torch_thread  # noqa: F401

The JAX side's threads are left as they are. The fixture's value is the
count it replaced: a test whose float32 result was calibrated under
torch's default pool (a reduction's split over threads sets its rounding)
runs that part under `torch_threads(one_torch_thread)`.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    with torch_threads(1):
        yield n


def test_one_torch_thread_inside_the_module():
    assert torch.get_num_threads() == 1
