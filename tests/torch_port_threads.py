"""One intra-op thread for PyTorch while a port test module runs.

The tier-1 run puts six xdist workers on the machine's cores, and each
PyTorch process would otherwise start as many intra-op threads as there
are cores: the port tests' small CPU operations then spend their time
contending for cores. Each tests/test_torch_port_*.py module imports
`one_torch_thread`, an autouse module-scoped fixture that sets one thread
before the module's first fixture and restores the previous count after
its last test, so that the modules that run next on the same worker are
unaffected.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
