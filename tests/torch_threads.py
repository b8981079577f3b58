"""The thread policy of the port's CPU tests, defined once.

Every `tests/test_torch_*.py` imports its pin from here, for example
`from torch_threads import one_torch_thread  # noqa: E402,F401`; an
autouse fixture imported into a test module applies to that module.
`test_torch_core.py::test_port_test_file_takes_the_shared_thread_pin`
holds each file to it.
"""
import pytest
import torch


def pin_torch_threads(n: int):
    """A module-scoped autouse fixture that runs its module with `n`
    intra-op threads and restores the count after it.

    The suite runs several workers on shared cores, and the port's plain
    path is many small ops that gain nothing from more threads, while an
    OpenMP pool spinning beside JAX's threads starves every worker."""
    @pytest.fixture(scope="module", autouse=True)
    def pin():
        old = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(old)
    return pin


one_torch_thread = pin_torch_threads(1)
# The long pole of its worker (the radix GPT-2 block's rounds), and the
# examples' demos: the other workers keep one thread each.
two_torch_threads = pin_torch_threads(2)
