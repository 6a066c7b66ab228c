"""Model definitions (NCHW, channels_last)."""

from unet_embroidery_seg_torch.models.factory import (
    SUPPORTED_MODELS,
    build_model,
    load_weights_flexible,
)

__all__ = ["SUPPORTED_MODELS", "build_model", "load_weights_flexible"]
