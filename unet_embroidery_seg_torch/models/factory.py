"""Model registry and construction (port of ``unet_embroidery_seg_tpu/models/factory.py``).

The registry keeps the reference's five names. ``unet_resnet50``,
``unet_plain``, ``attention_unet`` and ``dualdense_unet`` are ported;
``multitask_unet`` raises ``NotImplementedError`` naming the ROADMAP item
that ports it. ``load_weights_flexible`` is the shape-matched partial load
behind ``--weights``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import init_weights
from unet_embroidery_seg_torch.models.unet_attention import AttentionUNet
from unet_embroidery_seg_torch.models.unet_dualdense import DualDenseUNet
from unet_embroidery_seg_torch.models.unet_plain import UNetPlain
from unet_embroidery_seg_torch.models.unet_resnet import UNetResNet50
from unet_embroidery_seg_torch.utils.device import resolve_device

SUPPORTED_MODELS = (
    "unet_plain",
    "unet_resnet50",
    "attention_unet",
    "dualdense_unet",
    "multitask_unet",
)

_FAMILIES = {
    "unet_plain": UNetPlain,
    "attention_unet": AttentionUNet,
    "dualdense_unet": DualDenseUNet,
}

_NOT_PORTED = {
    "multitask_unet": "ROADMAP.md Queue 1 item 8 (multitask model and task)",
}


def build_model(
    model_name: str,
    num_classes: int,
    *,
    decoder_width: float = 1.0,
    diff_head: bool = False,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> nn.Module:
    """Construct and initialise a model by registry name, on ``device``.

    The weights are the reference 'normal' init drawn on the CPU from
    ``generator`` (seed 0 when none is given), so they do not depend on the
    device. The model lives in ``channels_last`` memory with float32
    parameters. ``diff_head=True`` (binary training) makes the model return
    the (N, H, W) logit difference instead of 2-channel logits, with the
    same parameters (``blocks.ClassHead``).
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
    if decoder_width != 1.0 and model_name != "unet_resnet50":
        raise ValueError(f"decoder_width is a unet_resnet50 option; got {decoder_width} "
                         f"for {model_name}")
    if model_name == "unet_resnet50":
        model = UNetResNet50(num_classes=num_classes, decoder_width=decoder_width,
                             diff_head=diff_head)
    else:
        model = _FAMILIES[model_name](num_classes=num_classes, diff_head=diff_head)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device=dev, memory_format=torch.channels_last)


def load_weights_flexible(model: nn.Module, state_dict: dict) -> tuple[int, int]:
    """Load the entries of ``state_dict`` whose key and shape both match, in place.

    The reference's ``model_factory.py:41-64`` semantics, as in the JAX
    package: everything else in ``model`` is kept as it is (so a finetune
    across a head-size change works), and (loaded, skipped) are returned.
    """
    own = model.state_dict()
    matched = {k: v for k, v in state_dict.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
    with torch.no_grad():
        for k, v in matched.items():
            own[k].copy_(v)
    return len(matched), len(state_dict) - len(matched)
