"""The hand-written kernels as registered PyTorch operators: the ``unet_seg`` namespace.

Each kernel entry point is a ``torch.library.custom_op``:

- ``unet_seg::upsample2x(x, align_corners)`` and
  ``unet_seg::upsample2x_backward(g, align_corners)`` (``ops/upsample.py``);
- ``unet_seg::conv3x3_bias_relu(x, weight, bias, cache, pad_top, pad_bottom,
  packed)``, ``unet_seg::conv3x3_same(x, weight, cache, pad_top, pad_bottom,
  packed)`` and ``unet_seg::conv3x3_dgrad(g, weight, packed, pad_top,
  pad_bottom)`` (``ops/conv3x3.py``; ``packed`` is the forward's
  ``pack_conv3x3_grad`` packing, which dgrad reads on the card).

Each has three implementations: on CUDA tensors the kernel's launch (its
checks raise, its ``.launches`` counter counts), on CPU tensors the plain
version, and a fake one for tracing that gives the output's shape, dtype
and strides (the kernels write ``torch.empty``'s channels_last strides).
So ``torch.export`` keeps the kernels as graph nodes, and the profiler
names each call ``unet_seg::<op>``. The autograd Functions of the two
modules call the operators; an operator has no autograd formula of its own.
``cache`` (the conv's packed-weight cache, grad mode off) is an argument,
so an inference graph exported under ``torch.no_grad()`` holds ``True``
(and no ``packed``); with grad on the autograd Function packs once and
passes the packing to the forward operator and, in its backward, to dgrad.

Importing ``ops.upsample`` and ``ops.conv3x3`` registers the operators;
``registered_ops`` imports both and returns the five.
"""

from __future__ import annotations

import torch

NAMESPACE = "unet_seg"
OP_NAMES = ("upsample2x", "upsample2x_backward", "conv3x3_bias_relu", "conv3x3_same",
            "conv3x3_dgrad")


def registered_ops() -> dict[str, torch._ops.OpOverload]:
    """The five operators by name, registered by importing the two kernel modules."""
    from unet_embroidery_seg_torch.ops import conv3x3, upsample  # noqa: F401  (registers)

    ns = getattr(torch.ops, NAMESPACE)
    return {name: getattr(ns, name).default for name in OP_NAMES}


def empty_kernel_output(shape, like: torch.Tensor) -> torch.Tensor:
    """An output as the kernels write it: ``torch.empty``'s channels_last strides.

    The fake implementations' output. They serve the meta device too, where
    no implementation computes anything, so a tensor on another device than
    the CPU or a card (a fake tensor reports the device it stands for)
    raises, as it does without tracing.
    """
    if like.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unet_seg: unsupported device {like.device}")
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=torch.channels_last)


def as_kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` with ``torch.empty``'s channels_last strides, copied only where they differ.

    For a plain version's output, so that an operator's CPU result has the
    strides of its CUDA and its fake result; ``contiguous`` keeps other
    strides where a dimension has size 1.
    """
    n, c, h, w = t.shape
    if t.stride() == (h * w * c, 1, w * c, c):
        return t
    return empty_kernel_output(t.shape, t).copy_(t)
