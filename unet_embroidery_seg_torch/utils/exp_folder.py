"""Experiment folders (copy of ``unet_embroidery_seg_tpu/utils/exp_folder.py``).

Training runs land in ``run/train/exp{,1,2,...}`` (the first free index)
with a ``weights/`` subfolder, predictions in ``run/predict/expN``, as in
the reference. ``scripts/make_tables.py`` globs ``run/train/exp*``.
"""

from __future__ import annotations

import os


def _next_exp_dir(parent: str) -> str:
    os.makedirs(parent, exist_ok=True)
    candidate = os.path.join(parent, "exp")
    if not os.path.exists(candidate):
        return candidate
    n = 1
    while True:
        candidate = os.path.join(parent, f"exp{n}")
        if not os.path.exists(candidate):
            return candidate
        n += 1


def create_exp_folder(root: str = "run") -> tuple[str, str]:
    """Create run/train/expN and its weights/; returns (exp_dir, weights_dir)."""
    exp_folder = _next_exp_dir(os.path.join(root, "train"))
    weights_folder = os.path.join(exp_folder, "weights")
    os.makedirs(weights_folder)
    return exp_folder, weights_folder


def create_val_exp_folder(root: str = "run") -> str:
    """Create run/predict/expN and return its path."""
    exp_folder = _next_exp_dir(os.path.join(root, "predict"))
    os.makedirs(exp_folder)
    return exp_folder
