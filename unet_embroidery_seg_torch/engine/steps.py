"""Step functions (port of ``make_predict_fn`` in ``engine/steps.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn


def make_predict_fn(model: nn.Module, amp: bool) -> Callable:
    """predict(images) -> logits: the inference forward with BN in eval mode.

    ``images`` are NHWC float32 canvases (numpy or tensor), as the JAX
    predict function takes them; the logits come back NHWC float32 on the
    model's device. NHWC is a free view of the model's NCHW
    ``channels_last`` layout in both directions.

    ``amp=True`` computes in bf16 with float32 parameters through
    ``torch.autocast``: the parameters are not copied, each op casts what it
    reads. The hand-written kernels are not autocast ops; their wrappers take
    the activation dtype (bf16 here) and cast their weights to it. BN runs
    on the bf16 activations with float32 statistics. Runs under
    ``torch.inference_mode``.
    """
    model.eval()
    device = next(model.parameters()).device

    def predict(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32).to(device)
        with torch.inference_mode(), torch.autocast(
            device.type, dtype=torch.bfloat16, enabled=amp
        ):
            logits = model(x.permute(0, 3, 1, 2))
        return logits.float().permute(0, 2, 3, 1)

    return predict
