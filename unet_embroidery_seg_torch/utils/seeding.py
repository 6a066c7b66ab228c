"""Seeding (port of ``utils/seeding.py``, which returns a JAX key).

Seeds Python's and numpy's global generators for the host-side pipeline and
torch's, and returns a CPU ``torch.Generator`` from the same seed for what
the port draws explicitly (the model's initial weights).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 11) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
