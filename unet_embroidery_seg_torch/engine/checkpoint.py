"""Model-only checkpoints (port of ``restore_variables`` in ``engine/checkpoint.py``).

The format is the reference's: ``torch.save`` of the model's float32
``state_dict`` under the reference keys, so a port ``.pth`` loads into the
original PyTorch code and through ``scripts/import_torch_checkpoint.py``
unchanged. Loading is strict, like the reference's val/predict.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn


def save_weights(path: str, model: nn.Module) -> None:
    """Write the model's ``state_dict`` (on the CPU) to ``path`` atomically."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Strict load of a model-only checkpoint into ``model`` (in place)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
