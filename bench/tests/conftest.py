"""Fixtures of the benchmark's CPU tests; the repository root, its
``src`` and the reference go on the import path."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "bench", "ref"), os.path.join(ROOT, "src"),
          ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops run fastest on one thread, and the tests may run beside
    other workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_caches():
    """The port's runner and consts caches emptied before and after, so a
    planted fault is built into the programs and leaves none behind."""
    from repro_torch.api import consts_cache_clear, runners
    runners.cache_clear()
    consts_cache_clear()
    yield
    runners.cache_clear()
    consts_cache_clear()
