"""Device-resident dataset and chunked epochs (port of ``engine/resident.py``).

The embroidery datasets are small (<= 584 train images, ~460 MB as uint8 at
512x512), so the input design of the JAX package on an accelerator is:

  1. upload the letterboxed uint8 canvases to device memory once
     (``ResidentData``),
  2. each epoch, upload only the shuffled (steps, B) index plan and its
     sample mask,
  3. run chunks of K steps: gather the batch on the card, augment it there
     (``ops/device_augment.py``) or only normalise it, and call the train or
     eval step of ``engine/steps.py``.

There is no ``lax.scan``: a chunk is a plain loop of K steps. What the steps
return stays on the card, stacked per chunk, so the caller reads it once per
chunk and the host can queue a whole chunk ahead of the card. The random
draws of step ``it`` of ``epoch`` (augmentation, multitask's dropout) come
from ``(seed, epoch, it)`` (``step_seeds``), so a resumed run draws what the
uninterrupted one drew.

Data parallelism (a ``Mesh`` of several ranks): every rank uploads the
whole split, as JAX replicates it, and plans the same global batches; step
``it`` draws the augmentation parameters of the whole global batch from its
seed, then gathers and augments only this rank's rows with their slice of
them, so the images do not depend on how the batch is split. Multitask's
dropout draws from ``(dropout seed, data index)`` on each rank
(``rank_seed``): no two data rows share a mask, and no split equals JAX's
one global mask. Over the space axis the ranks of one data index draw
alike (with one data index, the seed itself: the mask of one process), so
each image's class logits are the same on every rank of its space group,
and each rank computes its band of the output rows (``Mesh.band``): the
resample gathers from the replicated canvas, so no exchange is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from unet_embroidery_seg_torch.ops import device_augment
from unet_embroidery_seg_torch.parallel.mesh import Mesh
from unet_embroidery_seg_torch.utils.profiling import span


@dataclass
class ResidentData:
    """A whole split's canvases in device memory."""

    images_u8: torch.Tensor  # (N, H, W, 3) uint8
    masks_u8: torch.Tensor  # (N, H, W) uint8
    valid_wh: torch.Tensor  # (N, 2) float32
    cls_labels: torch.Tensor | None  # (N,) int32
    n: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.images_u8, self.masks_u8, self.valid_wh, self.cls_labels)
                   if t is not None)


def upload(cache, device: torch.device | str) -> ResidentData:
    """Copy a ``CanvasCache`` (or any object with its four arrays) to ``device``."""

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return ResidentData(
        images_u8=put(cache.images),
        masks_u8=put(cache.masks),
        valid_wh=put(cache.valid_wh),
        cls_labels=put(cache.cls_labels) if cache.cls_labels is not None else None,
        n=len(cache),
    )


def epoch_index_plan(
    n: int, batch_size: int, epoch: int, shuffle: bool, seed: int,
    max_batches: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side plan: (steps, B) int32 indices + (steps, B) f32 sample mask.

    The host loader's semantics: shuffle by (seed, epoch), the final partial
    batch padded by repeating, the padding masked out.
    """
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    idx_rows, mask_rows = [], []
    for start in range(0, n, batch_size):
        idxs = order[start : start + batch_size]
        n_valid = len(idxs)
        if n_valid < batch_size:
            reps = -(-batch_size // n_valid)
            idxs = np.tile(idxs, reps)[:batch_size]
        idx_rows.append(idxs)
        mask_rows.append((np.arange(batch_size) < n_valid).astype(np.float32))
        if max_batches and len(idx_rows) >= max_batches:
            break
    return np.stack(idx_rows).astype(np.int32), np.stack(mask_rows)


def upload_plan(idx: np.ndarray, mask: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The epoch's plan on ``device``, once per epoch; chunks slice it there."""
    return torch.from_numpy(idx).to(device), torch.from_numpy(mask).to(device)


def step_seeds(seed: int, epoch: int, it: int) -> tuple[int, int]:
    """(dropout seed, augmentation seed) of step ``it`` of ``epoch``.

    The first is the host-fed train loop's per-step seed, so both paths draw
    multitask's dropout alike; the second, the next word of the same
    ``SeedSequence``, seeds the augmentation's own generator.
    """
    a, b = np.random.SeedSequence((seed, epoch, it)).generate_state(2)
    return int(a), int(b)


def seed_default_generator(device: torch.device, seed: int) -> None:
    """Seed the generator that torch's own draws on ``device`` take (multitask's dropout).

    ``torch.manual_seed`` seeds every backend's, which costs host time each step.
    """
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.default_generators[index].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """``seed`` for one data index (one process, or one split over space); else one per data
    index, from ``(seed, d)``."""
    if mesh is None or mesh.n_data == 1:
        return seed
    return int(np.random.SeedSequence((seed, mesh.d)).generate_state(1)[0])


def _rows(mesh: Mesh | None, batch: int) -> slice:
    return slice(None) if mesh is None else mesh.rows(batch)


def _band(mesh: Mesh | None, h: int) -> slice | None:
    """This rank's band of ``h`` image rows, or None for whole images."""
    return None if mesh is None or mesh.n_space == 1 else mesh.band(h)


def gather_batch(data: ResidentData, idxs: torch.Tensor):
    """(images u8, masks u8, valid_wh, class labels or None) of the rows ``idxs``, on the card."""
    take = lambda t: t.index_select(0, idxs)  # noqa: E731
    cls = take(data.cls_labels) if data.cls_labels is not None else None
    return take(data.images_u8), take(data.masks_u8), take(data.valid_wh), cls


def _stack(outs: list):
    """Per-step outputs (tensors, or tuples / dicts of them) stacked along a new first axis."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    return torch.stack(outs)


def make_train_chunk_fn(
    train_step: Callable,
    input_shape: tuple[int, int],
    binary: bool,
    num_classes: int,
    multitask: bool = False,
    augment: bool = True,
    seed: int = 11,
    mesh: Mesh | None = None,
) -> Callable:
    """Build ``chunk(data, idx (K, B), mask (K, B), epoch, its)``, tensors on the card.

    Step k gathers the rows ``idx[k]``, augments them from its
    ``step_seeds(seed, epoch, its[k])`` generator on the card (or, with
    ``augment`` off, only normalises them) and calls ``train_step``, after
    seeding the device's default generator (multitask's dropout) by the
    same rule. Under a ``mesh`` the plan is the global batch's: the step
    takes this rank's rows of it and of the parameters drawn for all of it,
    and over the space axis this rank's band of the output rows.
    Returns the per-step losses stacked, (K,), on the card; for multitask a
    tuple ((K,) total, (K,) seg, (K,) cls, (K,) n_correct). Each step's
    gather, augmentation and seeding is an ``input.batch`` span
    (``utils/profiling.span``).
    """
    nc = None if binary else num_classes

    def chunk(data: ResidentData, idx: torch.Tensor, mask: torch.Tensor, epoch: int, its):
        outs = []
        rows = _rows(mesh, idx.shape[1])
        band = _band(mesh, input_shape[0])
        for k, it in enumerate(its):
            with span("input.batch"):
                dropout_seed, aug_seed = step_seeds(seed, epoch, it)
                imgs, masks, wh, cls = gather_batch(data, idx[k, rows])
                if augment:
                    gen = torch.Generator(device=imgs.device).manual_seed(aug_seed)
                    params = device_augment.sample_params(gen, idx.shape[1])
                    images, pngs = device_augment.augment_batch(
                        imgs, masks, wh, params=tuple(p[rows] for p in params),
                        out_hw=tuple(input_shape), binary=binary, num_classes=nc, band=band)
                else:
                    images, pngs = device_augment.preprocess_eval_batch(imgs, masks, binary, nc,
                                                                         band)
                seed_default_generator(imgs.device, rank_seed(dropout_seed, mesh))
            if multitask:
                losses, correct = train_step(images, pngs, cls, mask[k, rows])
                outs.append((*losses, correct.to(torch.float32)))
            else:
                outs.append(train_step(images, pngs, mask[k, rows]))
        return _stack(outs)

    return chunk


def make_eval_chunk_fn(
    eval_step: Callable,
    binary: bool,
    num_classes: int,
    multitask: bool = False,
    mesh: Mesh | None = None,
) -> Callable:
    """``chunk(data, idx, mask)`` -> the eval step's outputs, stacked per step, on the card.

    Each step gathers its rows (under a ``mesh``, this rank's rows of the
    global batch, and over the space axis its band of their rows),
    normalises them (the eval input is the cached canvas itself) and calls
    ``eval_step`` (with the class labels for multitask).
    """
    nc = None if binary else num_classes

    def chunk(data: ResidentData, idx: torch.Tensor, mask: torch.Tensor):
        outs = []
        rows = _rows(mesh, idx.shape[1])
        band = _band(mesh, data.images_u8.shape[1])
        with torch.inference_mode():
            for k in range(idx.shape[0]):
                imgs, masks, _, cls = gather_batch(data, idx[k, rows])
                images, pngs = device_augment.preprocess_eval_batch(imgs, masks, binary, nc,
                                                                     band)
                if multitask:
                    outs.append(eval_step(images, pngs, cls, mask[k, rows]))
                else:
                    outs.append(eval_step(images, pngs, mask[k, rows]))
            return _stack(outs)

    return chunk
