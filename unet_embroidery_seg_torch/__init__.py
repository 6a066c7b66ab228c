"""PyTorch/CUDA port of ``unet_embroidery_seg_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package imports
nothing of it (nor of JAX). Models compute in NCHW with
``torch.channels_last`` memory, which is the JAX package's NHWC byte order.
Entry points default to ``device="cuda"`` and raise without a card; the
CPU runs only when a caller passes ``device="cpu"``.
"""
