"""Binary segmentation metrics (port of the binary part of ``ops/metrics.py``).

Counts stay on the device (one int64 tensor of 4 per batch); the epoch loop
sums them and finalises on the host, as the JAX package does.
"""

from __future__ import annotations

import torch


def binary_confusion_counts(
    pred: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pixel-summed [tp, fp, fn, tn] (int64) of {0, 1} predictions against targets.

    ``sample_mask`` (N,) drops padded samples; ``ignore_index`` drops pixels.
    """
    pred_fg = pred == 1
    target_fg = target == 1
    valid = target != ignore_index if ignore_index is not None else torch.ones_like(target_fg)
    if sample_mask is not None:
        valid = valid & sample_mask.bool().reshape((-1,) + (1,) * (target.dim() - 1))
    return torch.stack([
        (pred_fg & target_fg & valid).sum(),
        (pred_fg & ~target_fg & valid).sum(),
        (~pred_fg & target_fg & valid).sum(),
        (~pred_fg & ~target_fg & valid).sum(),
    ]).to(torch.int64)


def binary_metrics_from_counts(
    tp: float, fp: float, fn: float, tn: float, eps: float = 1e-7
) -> dict[str, float]:
    """Dice / IoU / Precision / Recall / Accuracy from global counts (eps 1e-7)."""
    tp, fp, fn, tn = float(tp), float(fp), float(fn), float(tn)
    return {
        "Dice": (2.0 * tp) / (2.0 * tp + fp + fn + eps),
        "IoU": tp / (tp + fp + fn + eps),
        "Precision": tp / (tp + fp + eps),
        "Recall": tp / (tp + fn + eps),
        "Accuracy": (tp + tn) / (tp + tn + fp + fn + eps),
    }
