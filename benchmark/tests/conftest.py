"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of a checkout. Tests that need a CUDA card carry the `card` marker
and skip without one (`python -m pytest benchmark/tests -m card` on the
card)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the CPU runs here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
