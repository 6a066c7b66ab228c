"""Checkpoints (port of ``engine/checkpoint.py``).

- Model-only (best/last, val, predict): the reference's format, a
  ``torch.save`` of the model's float32 ``state_dict`` under the reference
  keys, so a port ``.pth`` loads into the original PyTorch code and through
  ``scripts/import_torch_checkpoint.py`` unchanged. The float32 parameters
  are the masters, so nothing is rounded. Loading is strict, like the
  reference's val/predict; ``restore_flexible`` is the shape-matched partial
  load behind ``--weights``.
- Full state (``--resume``): model, optimizer, step and the training loop's
  ``extra`` (epoch, best tracking, histories, seed) in one file.

Every write goes to a temporary file first and is renamed into place. A
tensor that is a view of a larger storage (a parameter bound into an
optimizer's flat arena) is copied out first, so each file holds each tensor
alone: ``torch.save`` of a view writes its whole storage.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.factory import load_weights_flexible


def _save(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _alone(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU, copied if it views a storage larger than itself."""
    t = t.detach().cpu()
    return t.clone() if t.untyped_storage().nbytes() > t.numel() * t.element_size() else t


def _cpu_state(state: dict) -> dict:
    return {k: _alone(v) for k, v in state.items()}


def save_weights(path: str, model: nn.Module | dict) -> None:
    """Write a model's ``state_dict`` (or a ``state_dict``), on the CPU, to ``path`` atomically."""
    _save(path, _cpu_state(model if isinstance(model, dict) else model.state_dict()))


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Strict load of a model-only checkpoint into ``model`` (in place)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def restore_flexible(path: str, model: nn.Module) -> tuple[int, int]:
    """Load the entries of a model-only checkpoint whose key and shape match; (loaded, skipped)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    loaded, skipped = load_weights_flexible(model, state)
    print(f"Loaded weights: {loaded} keys, Skipped: {skipped} keys")
    return loaded, skipped


def save_state(path: str, model: nn.Module, optimizer: torch.optim.Optimizer, step: int,
               extra: dict | None = None) -> None:
    """Write the full training state to ``path`` atomically (true resume)."""
    _save(path, {"model": _cpu_state(model.state_dict()), "optimizer": optimizer.state_dict(),
                 "step": int(step), "extra": extra or {}})


def restore_state(path: str, model: nn.Module,
                  optimizer: torch.optim.Optimizer) -> tuple[int, dict]:
    """Load a ``save_state`` file into ``model`` and ``optimizer`` in place; (step, extra)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"]), payload.get("extra", {})
