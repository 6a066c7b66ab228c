"""Fixtures of the benchmark's own tests (run: ``python -m pytest portbench/tests``).

Tests that need a CUDA card take the ``cuda_card`` fixture and carry the
``cuda`` marker; here they skip. Whether there is a card is decided inside
the fixture, never while a module is imported.
"""

from __future__ import annotations

import pytest
import torch

# Small shapes at which the CPU runs the whole harness: the program's kernels take their
# plain versions, every width stays as published.
TINY = {"train_chunk": {"size": 64, "batch": 4, "split": 12, "chunk": 4, "profile_steps": 4},
        "predict": {"size": 64, "batch": 4, "pool": 2, "profile_calls": 2, "check_share": 0.5}}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)
