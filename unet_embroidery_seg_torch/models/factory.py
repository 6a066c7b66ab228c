"""Model registry and construction (port of ``unet_embroidery_seg_tpu/models/factory.py``).

The registry keeps the reference's five names; only ``unet_resnet50`` is
ported so far, and the other four raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import init_weights
from unet_embroidery_seg_torch.models.unet_resnet import UNetResNet50
from unet_embroidery_seg_torch.utils.device import resolve_device

SUPPORTED_MODELS = (
    "unet_plain",
    "unet_resnet50",
    "attention_unet",
    "dualdense_unet",
    "multitask_unet",
)

_NOT_PORTED = {
    "unet_plain": "ROADMAP.md Queue 1 item 7 (other model families)",
    "attention_unet": "ROADMAP.md Queue 1 item 7 (other model families)",
    "dualdense_unet": "ROADMAP.md Queue 1 item 7 (other model families)",
    "multitask_unet": "ROADMAP.md Queue 1 items 7-8 (multitask model and task)",
}


def build_model(
    model_name: str,
    num_classes: int,
    *,
    decoder_width: float = 1.0,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> nn.Module:
    """Construct and initialise a model by registry name, on ``device``.

    The weights are the reference 'normal' init drawn on the CPU from
    ``generator`` (seed 0 when none is given), so they do not depend on the
    device. The model lives in ``channels_last`` memory with float32
    parameters.
    """
    dev = resolve_device(device)
    if model_name not in SUPPORTED_MODELS:
        raise ValueError(
            f"Unsupported model: {model_name}. Supported: {sorted(SUPPORTED_MODELS)}"
        )
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to PyTorch yet: {_NOT_PORTED[model_name]}"
        )
    model = UNetResNet50(num_classes=num_classes, decoder_width=decoder_width)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device=dev, memory_format=torch.channels_last)
