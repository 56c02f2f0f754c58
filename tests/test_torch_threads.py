"""The thread count that the port's CPU tests run PyTorch at.

Under pytest-xdist several workers share the host's cores.  At PyTorch's
default of one OpenMP thread per core, each worker's small convolutions,
reductions and gathers start as many threads as there are cores, and the
threads of six workers spin against one another; even alone, the HA tests of
``tests/test_torch_ha.py`` take several times as long as on one thread.
A test module takes ``_one_thread``, an autouse fixture, by importing it::

    from test_torch_threads import _one_thread  # noqa: F401  (autouse)

and each of its tests then runs at one intra-op thread, the count before it
put back after it, so that no other test on the same worker inherits it.
Child processes (ranks, CLIs, the supervisor) set their own counts.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch at ``n`` intra-op threads inside the block, the count before
    it put back after it, also when the block raises."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's small CPU tensors (module docstring)."""
    with torch_threads(1):
        yield


def test_tests_run_at_one_thread():
    assert torch.get_num_threads() == 1


@pytest.mark.parametrize("n", [2, 3])
def test_torch_threads_puts_the_count_back(n):
    before = torch.get_num_threads()
    with torch_threads(n):
        assert torch.get_num_threads() == n
    assert torch.get_num_threads() == before
    with pytest.raises(RuntimeError, match="inside"):
        with torch_threads(n):
            raise RuntimeError("inside")
    assert torch.get_num_threads() == before
