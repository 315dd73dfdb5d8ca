"""Torch's intra-op threads per pytest-xdist worker, for the port's test
files whose CPU loops make many small torch ops.

Each worker process starts with torch's default pool (one thread per core),
and every small op synchronises it: with several workers on the cores such
a loop runs an order of magnitude slower than on an idle machine. Under
xdist (``PYTEST_XDIST_WORKER_COUNT`` set) ``worker_threads()`` is this
worker's share of the cores. ``cap_torch_threads`` is a module-scoped
autouse fixture that runs a whole module at that count and restores the
caller's afterwards:

    from tests.torch_threads import cap_torch_threads  # noqa: F401
"""

import os

import pytest
import torch

from speaker3d_tpu_torch.utils.threads import cpu_threads


def worker_threads() -> int:
    """This xdist worker's share of the cores; outside xdist torch's own
    count."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return torch.get_num_threads()
    return max(1, (os.cpu_count() or 1) // int(workers))


@pytest.fixture(scope="module", autouse=True)
def cap_torch_threads():
    with cpu_threads(worker_threads()):
        yield
