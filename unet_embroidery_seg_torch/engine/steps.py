"""Step functions (port of ``engine/steps.py``: predict and the binary train/eval steps).

The JAX steps are jitted pure functions of (state, batch); the port's are
eager closures over the model and optimizer, which they update in place.
Each takes NHWC float32 images (numpy or tensor), as the JAX steps do; NHWC
is a free view of the model's NCHW ``channels_last`` layout. ``amp=True``
computes in bf16 through ``torch.autocast`` with float32 parameters: each op
casts what it reads. The hand-written kernels are not autocast ops; their
wrappers take the activation dtype (bf16 here) and cast their weights to it.
BN runs on the bf16 activations with float32 statistics. ``sample_mask``
(N,) neutralises the padded samples of a tail batch in the loss and counts.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from unet_embroidery_seg_torch.ops import losses, metrics


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _inputs(device: torch.device, images, pngs=None, sample_mask=None):
    x = torch.as_tensor(images, dtype=torch.float32).to(device).permute(0, 3, 1, 2)
    t = None if pngs is None else torch.as_tensor(pngs).to(device)
    sm = None if sample_mask is None else torch.as_tensor(sample_mask, dtype=torch.float32).to(device)
    return x, t, sm


def _nhwc(outputs: torch.Tensor) -> torch.Tensor:
    """The model's (N, H, W) diff or (N, K, H, W) logits in the JAX layout."""
    return outputs if outputs.dim() == 3 else outputs.permute(0, 2, 3, 1)


def make_predict_fn(model: nn.Module, amp: bool) -> Callable:
    """predict(images) -> logits: the inference forward with BN in eval mode.

    The logits come back NHWC float32 on the model's device. Runs under
    ``torch.inference_mode``.
    """
    model.eval()
    device = _device(model)

    def predict(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x, _, _ = _inputs(device, images)
        with torch.inference_mode(), torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
            logits = model(x)
        return logits.float().permute(0, 2, 3, 1)

    return predict


def make_binary_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str,
    pos_weight: float | None = None,
    ignore_index: int | None = None,
    amp: bool = True,
) -> Callable:
    """train_step(images, pngs, sample_mask) -> loss (0-d float32 tensor on the device).

    One forward in train mode (BN batch statistics, running stats updated),
    the binary loss, backward, and one optimizer step.
    """
    device = _device(model)

    def train_step(images, pngs, sample_mask) -> torch.Tensor:
        model.train()
        x, t, sm = _inputs(device, images, pngs, sample_mask)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
            outputs = model(x)
        loss = losses.binary_segmentation_loss(
            _nhwc(outputs), t, loss_name=loss_name, pos_weight=pos_weight,
            ignore_index=ignore_index, sample_mask=sm,
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_binary_eval_step(
    model: nn.Module,
    loss_name: str,
    pos_weight: float | None = None,
    ignore_index: int | None = None,
    amp: bool = True,
) -> Callable:
    """eval_step(images, pngs, sample_mask) -> (loss, counts[4]) on the device.

    The prediction is ``diff > 0`` for a diff-head model (which equals the
    argmax of its two logits) and the argmax otherwise.
    """
    device = _device(model)

    def eval_step(images, pngs, sample_mask):
        model.eval()
        x, t, sm = _inputs(device, images, pngs, sample_mask)
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = _nhwc(model(x))
            loss = losses.binary_segmentation_loss(
                outputs, t, loss_name=loss_name, pos_weight=pos_weight,
                ignore_index=ignore_index, sample_mask=sm,
            )
            pred = (outputs > 0).long() if outputs.dim() == 3 else outputs.argmax(-1)
            counts = metrics.binary_confusion_counts(pred, t, ignore_index=ignore_index,
                                                     sample_mask=sm)
        return loss, counts

    return eval_step
