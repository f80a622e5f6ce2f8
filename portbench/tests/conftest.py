"""Fixtures of the benchmark's CPU tests."""
from __future__ import annotations

import pytest

import portbench.tests.tiny  # noqa: F401  (puts src/ on the path)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
