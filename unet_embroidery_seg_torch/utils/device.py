"""Device resolution and float32 precision for the port's entry points."""

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


def set_float32_precision() -> None:
    """Set, and so state, the float32 precision of the card's library calls.

    The train, val and predict CLIs call this; the values are PyTorch's
    defaults, so the port's numbers stay comparable with earlier runs. With
    ``--no-amp`` (float32):

    - matrix products run in full float32 (``matmul.allow_tf32 = False``);
    - cuDNN's convolutions (the width-changing 3x3 and 1x1 convs, the stem,
      every wgrad) run in TF32, about three decimal digits
      (``cudnn.allow_tf32 = True``);
    - the hand-written square 3x3 conv (``ops/conv3x3.py``, forward and
      dgrad) is f32-accurate whatever these say: 3xTF32 on the tensor cores
      (``tf32x3``), or the CUDA cores (``fma``).

    Whether ``--no-amp`` should turn cuDNN's TF32 off is an open question
    (ROADMAP Queue 3). Under bf16 autocast neither flag matters.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
