"""Segmentation metrics (port of ``ops/metrics.py``): binary, multiclass and multitask.

Counts stay on the device (int64 tensors per batch); the epoch loop sums
them and finalises on the host, as the JAX package does. The multiclass
metrics follow the reference's per-batch statistic (classes present in the
batch), and ``multiclass_per_sample_sums`` the val CLI's per-sample one.

Data parallelism: each counting function takes an optional process
``group`` (None: the single-device code) and sums its counts, tables and
sums over the group before any finalisation, so every rank returns the
global batch's numbers (``multiclass_batch_metrics`` is a per-global-batch
metric, as in JAX). Over the mesh's space axis (each rank holds a band of
every image's rows, ``group`` spans every band) the pixel counts and
tables need nothing more; the per-sample metrics take ``space`` and sum
each image's tables over its space group first.
"""

from __future__ import annotations

import torch

from unet_embroidery_seg_torch.parallel.mesh import Group, global_count


def binary_confusion_counts(
    pred: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int | None = None,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """Pixel-summed [tp, fp, fn, tn] (int64) of {0, 1} predictions against targets.

    ``sample_mask`` (N,) drops padded samples; ``ignore_index`` drops pixels.
    """
    pred_fg = pred == 1
    target_fg = target == 1
    valid = target != ignore_index if ignore_index is not None else torch.ones_like(target_fg)
    if sample_mask is not None:
        valid = valid & sample_mask.bool().reshape((-1,) + (1,) * (target.dim() - 1))
    return global_count(torch.stack([
        (pred_fg & target_fg & valid).sum(),
        (pred_fg & ~target_fg & valid).sum(),
        (~pred_fg & target_fg & valid).sum(),
        (~pred_fg & ~target_fg & valid).sum(),
    ]).to(torch.int64), group)


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


def _per_class_tables(pred: torch.Tensor, target: torch.Tensor, num_classes: int):
    """Per-class (intersection, union, target count, pred count) int64 tables over every pixel."""
    classes = torch.arange(num_classes, device=target.device).reshape(-1, *[1] * target.dim())
    t, p = target[None] == classes, pred[None] == classes
    axes = tuple(range(1, t.dim()))
    return (t & p).sum(axes), (t | p).sum(axes), t.sum(axes), p.sum(axes)


def multiclass_batch_metrics(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> dict[str, torch.Tensor]:
    """One batch's Pixel / Mean Accuracy, Mean IoU and FW IoU (float32 scalars), JAX's semantics.

    Mean Accuracy and Mean IoU average over the classes present in the
    target; FW IoU weights every class's IoU (0 where its union is empty) by
    its frequency. ``logits`` (N, H, W, K); with ``sample_mask`` the invalid
    samples' predictions and targets go to -1 and -2, which no class counts.
    """
    pred = logits.argmax(-1)
    if sample_mask is not None:
        sm = sample_mask.bool().reshape((-1,) + (1,) * (target.dim() - 1))
        pred = torch.where(sm, pred, -1)
        target = torch.where(sm, target, -2)
    inter, union, t_cnt, _ = _per_class_tables(pred, target, num_classes)
    correct = pred == target
    if group is not None:  # the integer tables and pixel counts summed over the ranks
        n_pix = (sample_mask.bool().sum() * target[0].numel() if sample_mask is not None
                 else torch.full_like(inter[0], target.numel()))
        tables = global_count(torch.cat([inter, union, t_cnt, correct.sum()[None], n_pix[None]]),
                              group)
        inter, union, t_cnt = tables[:-2].reshape(3, -1).unbind()
        pixel_acc = tables[-2].float() / tables[-1].float().clamp_min(1.0)
    elif sample_mask is not None:
        n_valid_pix = (sample_mask.float().sum() * float(target[0].numel())).clamp_min(1.0)
        pixel_acc = correct.float().sum() / n_valid_pix
    else:
        pixel_acc = correct.float().mean()
    inter, union, t_cnt = inter.float(), union.float(), t_cnt.float()
    present = t_cnt > 0
    n_present = present.float().sum().clamp_min(1.0)
    acc_per_class = torch.where(present, inter / t_cnt.clamp_min(1.0), 0.0)
    iou_per_class = torch.where(union > 0, inter / union.clamp_min(1.0), 0.0)
    return {
        "Pixel Accuracy": pixel_acc,
        "Mean Accuracy": acc_per_class.sum() / n_present,
        "Mean IoU": torch.where(present, iou_per_class, 0.0).sum() / n_present,
        "Frequency Weighted IoU": (t_cnt * iou_per_class).sum() / t_cnt.sum().clamp_min(1.0),
    }


def multiclass_per_sample_sums(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
    space=None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Per-SAMPLE multiclass metrics summed over the valid samples, and their count.

    The reference val CLI evaluates at batch size 1, so its number is a mean
    of per-sample metrics (class presence per sample). This gives that
    statistic at any batch size: metric = sum of sums / sum of counts.
    ``space``: ``logits`` and ``target`` are bands; each image's tables are
    summed over its space group (class presence is the image's), and space
    index 0 counts the image.
    """
    band_group = None if space is None else space.group
    per_sample = [multiclass_batch_metrics(lg[None], tg[None], num_classes, group=band_group)
                  for lg, tg in zip(logits, target)]
    sm = (torch.ones(target.shape[0], device=target.device) if sample_mask is None
          else sample_mask.float())
    if space is not None:
        sm = sm * float(space.first)
    sums = {k: (torch.stack([m[k] for m in per_sample]) * sm).sum() for k in per_sample[0]}
    if group is None:
        return sums, sm.sum()
    total = global_count(torch.stack([*sums.values(), sm.sum()]), group)
    return dict(zip(sums, total[:-1].unbind())), total[-1]


def multitask_seg_counts(
    seg_logits: torch.Tensor,
    seg_targets: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """[intersection, union, pred sum, target sum] (int64) of ``sigmoid(seg) > 0.5`` against the masks.

    ``seg_logits`` (N, H, W, 1); summed over a split they give the
    reference's split-global IoU and Dice.
    """
    pred = torch.sigmoid(seg_logits[..., 0].float()) > 0.5
    tgt = seg_targets == 1
    if sample_mask is not None:
        sm = sample_mask.bool().reshape((-1,) + (1,) * (tgt.dim() - 1))
        pred, tgt = pred & sm, tgt & sm
    return global_count(torch.stack([(pred & tgt).sum(), (pred | tgt).sum(), pred.sum(),
                                     tgt.sum()]).to(torch.int64), group)


def multitask_seg_metrics_from_counts(
    inter: float, union: float, psum: float, tsum: float
) -> dict[str, float]:
    """IoU and Dice from split-global counts (eps 1e-6)."""
    return {"IoU": float(inter) / (float(union) + 1e-6),
            "Dice": 2.0 * float(inter) / (float(psum) + float(tsum) + 1e-6)}
