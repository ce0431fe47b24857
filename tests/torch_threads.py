"""One torch intra-op thread for the port's CPU tests.

Under ``pytest -n N`` each worker's torch would start one OpenMP thread per
core, and the small ops of these tests then wait at barriers for threads
that the other workers keep off the cores.  A test module imports the
fixture below (autouse) to run on one thread and give the count back when
it is done."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
