"""One intra-op thread for the port's CPU tests.

The suite runs several pytest-xdist workers on the machine's cores. With
torch's default of a thread per core in every worker, the smoke-sized ops
of the port's tests oversubscribe the CPU several times over, which makes
the suite about twice as slow. A test module that imports ``one_thread``
runs with one torch intra-op thread and restores the worker's setting at
its end.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
