"""The one-thread fixture of the port's CPU tests, in a module without JAX,
so that the tests that also run on the card's machine (where JAX is not
installed) can take it. `torch_port_harness` re-exports it."""
import pytest
import torch

# torch's intra-op threads before any fixture here changes them
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while a module that imports this fixture
    runs, then back. The CPU test run puts six pytest-xdist workers on the
    machine's cores; each torch op would wake one thread a core in every
    worker, and the small ops of the tiny models then wait on each other (a
    test of 2 s alone took over 70 s in a six-worker run on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_torch_threads():
    """torch at its own intra-op thread count for one test, in a module that
    runs on one thread: for a test whose float32 result depends on the order
    of torch's CPU sums, which the thread count sets."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)
