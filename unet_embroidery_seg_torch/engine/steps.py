"""Step functions (port of ``engine/steps.py``): predict, and train/eval for the three tasks.

The JAX steps are jitted pure functions of (state, batch); the port's are
eager closures over the model and optimizer, which they update in place.
Each takes NHWC float32 images (numpy or tensor), as the JAX steps do; NHWC
is a free view of the model's NCHW ``channels_last`` layout. ``amp=True``
computes in bf16 through ``torch.autocast`` with float32 parameters: each op
casts what it reads. The hand-written kernels are not autocast ops; their
wrappers take the activation dtype (bf16 here) and cast their weights to it.
BN runs on the bf16 activations with float32 statistics. ``sample_mask``
(N,) neutralises the padded samples of a tail batch in the loss and counts.
A multitask model returns ``(seg, cls)``; its steps take the (N,) class
labels too, and train mode keeps its dropout on.

Data parallelism: each train and eval step takes an optional process
``group``; None (one process) is the single-device step. With a group a
train step runs the model through ``DistributedDataParallel`` (gradients
averaged over the ranks) with its BatchNorms' statistics summed over the
group, and the losses and counts are the global batch's (``ops/losses.py``,
``ops/metrics.py``): every rank returns the same numbers. Build one train
step per model, as DDP hooks the parameters. Eval steps run the model
itself (running statistics, no wrapper) and return global counts.

The mesh's space axis (every train and eval step; ``space``:
``parallel/halo.SpaceAxis``): each rank's images are a band of every
image's rows, ``group`` is the whole job (BN, the losses, the counts and
DDP span data x space), and the model's row-reading modules take their
halos over ``space`` (``blocks.set_space_axis``); the Lovasz hinge gathers
whole images. What is per image (multitask's class CE, correct count and
confusion; the per-sample eval's losses and metrics) is summed over the
image's space group where it is a sum of bands, and counted by space
index 0 only.

Spans (``utils/profiling.span``, recorded only while a profiler records):
every train step is ``step.train``, its phases ``step.forward`` (the
inputs to the card and the forward), ``step.loss``, ``step.backward`` and
``step.optimizer`` (``optimizer.step()``), in that order. The gradients'
``zero_grad`` (set to None: no card work) opens ``step.backward``, so the
gradients stay readable after the step, as before. A predict call is
``predict.h2d`` (the inputs' upload) then ``predict.forward``, inside
``predict.predict_probs``' ``predict.call``. Eval steps have no spans.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from unet_embroidery_seg_torch.models.blocks import set_batchnorm_group, set_space_axis
from unet_embroidery_seg_torch.ops import losses, metrics
from unet_embroidery_seg_torch.parallel.mesh import Group, global_count
from unet_embroidery_seg_torch.utils.profiling import span


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _inputs(device: torch.device, images, pngs=None, sample_mask=None, cls_targets=None):
    """(images NCHW, targets, sample_mask, class labels) on ``device``; absent ones stay None."""
    x = torch.as_tensor(images, dtype=torch.float32).to(device).permute(0, 3, 1, 2)
    t = None if pngs is None else torch.as_tensor(pngs).to(device)
    sm = None if sample_mask is None else torch.as_tensor(sample_mask, dtype=torch.float32).to(device)
    cls = None if cls_targets is None else torch.as_tensor(cls_targets).to(device).long()
    return x, t, sm, cls


def _nhwc(outputs):
    """The model's outputs in the JAX layout: (N, K, H, W) logits to NHWC, others as they are.

    A (N, H, W) diff and multitask's (N, K) class logits stay; a tuple maps.
    """
    if isinstance(outputs, tuple):
        return tuple(_nhwc(o) for o in outputs)
    return outputs.permute(0, 2, 3, 1) if outputs.dim() == 4 else outputs


def _replica(model: nn.Module, group: Group) -> nn.Module:
    """What a train step calls: ``model``, or under a group DDP over it with synchronised BN.

    No buffer sync at each forward (``broadcast_buffers=False``): the
    single-device BN rebinds its running variance each train forward, which
    DDP's buffer broadcast would not follow; the synchronised BN keeps the
    ranks' statistics equal anyway.
    """
    if group is None:
        return model
    from torch.nn.parallel import DistributedDataParallel

    set_batchnorm_group(model, group)
    # newer torch names the per-forward buffer sync ``forward_sync_buffers``
    off = ("forward_sync_buffers" if "forward_sync_buffers"
           in inspect.signature(DistributedDataParallel.__init__).parameters
           else "broadcast_buffers")
    # Over more than two ranks a ring all-reduce sums each gradient in an
    # order set by its place in its bucket, and DDP rebuilds its buckets on
    # a run's first step, so a resumed run would sum in other orders than
    # the run it continues. With find_unused_parameters the buckets keep
    # their first layout (every parameter is used, so nothing else changes).
    keep_buckets = dist.get_world_size(group) > 2
    return DistributedDataParallel(model, process_group=group,
                                   find_unused_parameters=keep_buckets, **{off: False})


def _once(sample_mask: torch.Tensor, space) -> torch.Tensor:
    """The sample mask of what is counted per image: over the space axis, by space index 0 only."""
    return sample_mask if space is None else sample_mask * float(space.first)


def _backward_and_step(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    with span("step.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("step.optimizer"):
        optimizer.step()


def _train_span(train_step: Callable) -> Callable:
    """``train_step`` inside a ``step.train`` span, the root of the step's phases."""

    @functools.wraps(train_step)
    def spanned(*args):
        with span("step.train"):
            return train_step(*args)

    return spanned


def make_predict_fn(model: nn.Module, amp: bool) -> Callable:
    """predict(images) -> logits: the inference forward with BN in eval mode.

    The logits come back NHWC float32 on the model's device (multitask:
    the ``(seg, cls)`` pair). Runs under ``torch.inference_mode``, on whole
    images (no space axis, as JAX's predict has no mesh).
    """
    model.eval()
    device = _device(model)

    def predict(images: np.ndarray | torch.Tensor):
        set_space_axis(model, None)
        with span("predict.h2d"):
            x, _, _, _ = _inputs(device, images)
        with span("predict.forward"), torch.inference_mode(), \
                torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
            logits = model(x)
        return _nhwc(logits)

    return predict


def make_binary_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str,
    pos_weight: float | None = None,
    ignore_index: int | None = None,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """train_step(images, pngs, sample_mask) -> loss (0-d float32 tensor on the device).

    One forward in train mode (BN batch statistics, running stats updated),
    the binary loss, backward, and one optimizer step. ``space``: the
    images and masks are this rank's band of rows (module docstring).
    """
    device = _device(model)
    net = _replica(model, group)

    @_train_span
    def train_step(images, pngs, sample_mask) -> torch.Tensor:
        with span("step.forward"):
            model.train()
            set_space_axis(model, space)
            x, t, sm, _ = _inputs(device, images, pngs, sample_mask)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = net(x)
        with span("step.loss"):
            loss = losses.binary_segmentation_loss(
                _nhwc(outputs), t, loss_name=loss_name, pos_weight=pos_weight,
                ignore_index=ignore_index, sample_mask=sm, group=group, space=space,
            )
        _backward_and_step(optimizer, loss)
        return loss.detach()

    return train_step


def make_binary_eval_step(
    model: nn.Module,
    loss_name: str,
    pos_weight: float | None = None,
    ignore_index: int | None = None,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """eval_step(images, pngs, sample_mask) -> (loss, counts[4]) on the device.

    The prediction is ``diff > 0`` for a diff-head model (which equals the
    argmax of its two logits) and the argmax otherwise. ``space``: as the
    train step's.
    """
    device = _device(model)

    def eval_step(images, pngs, sample_mask):
        model.eval()
        set_space_axis(model, space)
        x, t, sm, _ = _inputs(device, images, pngs, sample_mask)
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = _nhwc(model(x))
            loss = losses.binary_segmentation_loss(
                outputs, t, loss_name=loss_name, pos_weight=pos_weight,
                ignore_index=ignore_index, sample_mask=sm, group=group, space=space,
            )
            pred = (outputs > 0).long() if outputs.dim() == 3 else outputs.argmax(-1)
            counts = metrics.binary_confusion_counts(pred, t, ignore_index=ignore_index,
                                                     sample_mask=sm, group=group)
        return loss, counts

    return eval_step


def make_multiclass_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    num_classes: int,
    focal: bool = False,
    use_dice: bool = True,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """train_step(images, pngs, sample_mask) -> loss: CE or focal (+ Dice) on K-class logits."""
    device = _device(model)
    net = _replica(model, group)

    @_train_span
    def train_step(images, pngs, sample_mask) -> torch.Tensor:
        with span("step.forward"):
            model.train()
            set_space_axis(model, space)
            x, t, sm, _ = _inputs(device, images, pngs, sample_mask)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = net(x)
        with span("step.loss"):
            loss = losses.multiclass_loss(_nhwc(outputs), t, num_classes, focal, use_dice, sm,
                                          group=group)
        _backward_and_step(optimizer, loss)
        return loss.detach()

    return train_step


def make_multiclass_eval_step(
    model: nn.Module,
    num_classes: int,
    focal: bool = False,
    use_dice: bool = True,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """eval_step(images, pngs, sample_mask) -> (loss, {Pixel Accuracy, Mean Accuracy, Mean IoU,
    Frequency Weighted IoU}): the per-batch values the train CLI averages over batches."""
    device = _device(model)

    def eval_step(images, pngs, sample_mask):
        model.eval()
        set_space_axis(model, space)
        x, t, sm, _ = _inputs(device, images, pngs, sample_mask)
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = _nhwc(model(x))
            loss = losses.multiclass_loss(outputs, t, num_classes, focal, use_dice, sm,
                                          group=group)
            return loss, metrics.multiclass_batch_metrics(outputs, t, num_classes, sm,
                                                          group=group)

    return eval_step


def make_multiclass_persample_eval_step(
    model: nn.Module,
    num_classes: int,
    focal: bool = False,
    use_dice: bool = True,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """eval_step(images, pngs, sample_mask) -> (loss_sum, metric_sums, n_valid), per SAMPLE.

    The reference val CLI's statistic (batch size 1) at any batch size: the
    caller divides the summed metrics and losses by the summed ``n_valid``.
    ``space``: each image's loss sums its numerators and normalisers over
    its space group, as its metrics sum their tables, and space index 0
    counts it.
    """
    device = _device(model)
    band_group = None if space is None else space.group

    def eval_step(images, pngs, sample_mask):
        model.eval()
        set_space_axis(model, space)
        x, t, sm, _ = _inputs(device, images, pngs, sample_mask)
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                outputs = _nhwc(model(x))
            per_sample = torch.stack([
                losses.multiclass_loss(lg[None], tg[None], num_classes, focal, use_dice,
                                       group=band_group)
                for lg, tg in zip(outputs, t)])
            sums, n_valid = metrics.multiclass_per_sample_sums(outputs, t, num_classes, sm,
                                                               group=group, space=space)
            return global_count((per_sample * _once(sm, space)).sum(), group), sums, n_valid

    return eval_step


def make_multitask_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    seg_loss_name: str = "bce",
    cls_loss_weight: float = 1.0,
    pos_weight: float | None = None,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """train_step(images, pngs, cls_targets, sample_mask) -> ((total, seg, cls), n_cls_correct).

    Train mode: BN batch statistics and the class head's dropout. ``pos_weight``
    weights the seg BCE's positive term; None (the default) is the
    reference's unweighted loss. ``space``: the caller seeds the dropout by
    data index, so an image's space ranks draw the same mask.
    """
    device = _device(model)
    net = _replica(model, group)

    @_train_span
    def train_step(images, pngs, cls_targets, sample_mask):
        with span("step.forward"):
            model.train()
            set_space_axis(model, space)
            x, t, sm, cls = _inputs(device, images, pngs, sample_mask, cls_targets)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                seg, logits = _nhwc(net(x))
        with span("step.loss"):
            total, seg_l, cls_l = losses.multitask_loss(
                seg, logits, t, cls, seg_loss_name=seg_loss_name,
                cls_loss_weight=cls_loss_weight, sample_mask=sm, pos_weight=pos_weight,
                group=group, space=space)
        _backward_and_step(optimizer, total)
        hits = (logits.detach().argmax(-1) == cls).float() * _once(sm, space)
        correct = global_count(hits.sum().long(), group)
        return (total.detach(), seg_l.detach(), cls_l.detach()), correct

    return train_step


def make_multitask_eval_step(
    model: nn.Module,
    seg_loss_name: str = "bce",
    cls_loss_weight: float = 1.0,
    pos_weight: float | None = None,
    amp: bool = True,
    group: Group = None,
    space=None,
) -> Callable:
    """eval_step(images, pngs, cls_targets, sample_mask) -> ((total, seg, cls), seg_counts[4],
    confusion[K, K]) for K classes: the confusion (rows: target, columns: prediction) counts
    valid samples only (over the space axis, each once)."""
    device = _device(model)

    def eval_step(images, pngs, cls_targets, sample_mask):
        model.eval()
        set_space_axis(model, space)
        x, t, sm, cls = _inputs(device, images, pngs, sample_mask, cls_targets)
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=amp):
                seg, logits = _nhwc(model(x))
            loss_triple = losses.multitask_loss(
                seg, logits, t, cls, seg_loss_name=seg_loss_name,
                cls_loss_weight=cls_loss_weight, sample_mask=sm, pos_weight=pos_weight,
                group=group, space=space)
            seg_counts = metrics.multitask_seg_counts(seg, t, sample_mask=sm, group=group)
            # one-hot products in f32 (exact for counts below 2^24), as JAX's einsum
            k = logits.shape[-1]
            onehot_tgt = F.one_hot(cls, k).float() * _once(sm, space)[:, None]
            onehot_pred = F.one_hot(logits.argmax(-1), k).float()
            confusion = global_count((onehot_tgt.T @ onehot_pred).round().long(), group)
            return loss_triple, seg_counts, confusion

    return eval_step
