"""One intra-op thread for PyTorch, and one for BLAS, while a port test
module runs.

The tier-1 run puts six xdist workers on the machine's cores, and each
PyTorch process would otherwise start as many intra-op threads as there
are cores: the port tests' small CPU operations then spend their time
contending for cores. Each tests/test_torch_port_*.py module imports
`one_torch_thread`, an autouse module-scoped fixture that sets one thread
before the module's first fixture and restores the previous count after
its last test, so that the modules that run next on the same worker are
unaffected.

The BLAS libraries loaded in the process (numpy's and scipy's OpenBLAS:
the FID/FVD square roots, the statistics) likewise get one thread while the
module runs (threadpoolctl, where it is installed): six workers' full BLAS
thread pools on the same cores spin against each other, which made a test
of the metric embedders take four times its time alone.
"""

import contextlib

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        import scipy.linalg  # noqa: F401  (its OpenBLAS, loaded before the limit is set)
        from threadpoolctl import threadpool_limits
    except ImportError:
        blas = contextlib.nullcontext()
    else:
        blas = threadpool_limits(limits=1, user_api="blas")
    with blas:
        yield
    torch.set_num_threads(threads)
