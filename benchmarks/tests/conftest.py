"""One torch thread a test process: several test processes share the
machine's cores, and torch's intra-op pools would contend for them."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
