"""Tests of the benchmark harness. Run them from the repository's root:
``python -m pytest portbench/tests -q -n 6``. The ``cuda`` tests need a
card and skip without one."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    # several xdist workers each running torch on the CPU: one intra-op
    # thread a worker keeps the tiny engine runs from starving each other
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
