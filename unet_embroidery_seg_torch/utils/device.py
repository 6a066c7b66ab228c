"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; ``cuda`` raises when no card is present.

    There is no silent fall back to the CPU: a caller that wants the CPU
    (the tests) says so with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
