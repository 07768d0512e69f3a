"""One intra-op thread for the port's CPU tests.

The port's tests run at small widths, where torch's intra-op thread pool
buys no time; its idle workers spin, and under a parallel test run they
take cores from the other workers. A test module imports the fixture
below (``from tests.torch_threads import one_torch_thread``) and runs with
one thread; the count is restored after the module.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
