"""A module-scoped fixture that runs a test module's torch work on one thread.

The port's plain walks (the CPU path) are many small tensor ops. When the
suite runs in several worker processes on a machine of a few cores,
torch's intra-op thread pool in each of them contends for the same
cores, and such a module slows by tens of times (16 channels x bs256:
85 s against 1.5 s for one batch_encode with the other cores busy). One
thread a process avoids that. Import the fixture by name into a test
module to apply it there; the previous thread count is restored after
the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
