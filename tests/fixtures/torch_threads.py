"""``torch_threads``: the port's CPU tests with torch's intra-op threads
at this worker's share of the cores.

pytest-xdist runs the suite in several worker processes, and each
process's torch would otherwise start one OpenMP thread a core: with 6
workers on 8 cores that is 48 threads spinning for 8 cores, and the
port's tests took 2.3 times as long as with one thread a worker (the
``--dist loadfile`` run of the port's tests, 581 s against 248 s on an
8-core machine). A test module imports this fixture; it is autouse, and
sets the count the first time a worker runs such a module. The count is
left so for the worker's later tests: setting it rebuilds torch's thread
pools, which is not safe while another thread of the process (a loader's
prefetch thread) may be in one, so it is set once and not switched back
and forth between modules. Without xdist the count stays torch's own.
The checks are the same: only the order in which a parallel reduction
adds its partial sums can change, which every tolerance of these tests
already allows for (the kernels' plain versions and the JAX package sum
in other orders again)."""
import os

import pytest
import torch


def worker_threads() -> int:
    """The cores this process may use over the xdist workers, at least 1;
    torch's own count without xdist."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '0'))
    if workers < 2:
        return torch.get_num_threads()
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True, scope='module')
def torch_threads():
    n = worker_threads()
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n
