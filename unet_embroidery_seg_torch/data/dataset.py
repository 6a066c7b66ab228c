"""Per-sample transforms and the loader (copy of ``unet_embroidery_seg_tpu/data/dataset.py``).

The same per-(seed, epoch, index) randomness, order and ``n_valid`` tail
padding as the JAX package, so both see the same batches. The JAX
package's description follows.

Per-sample transform pipeline + batched, prefetching loader.

Parity target: ``HFUnetDataset.__getitem__`` + ``hf_unet_dataset_collate``
(the reference's utils/hf_dataloader.py:67-105, 183-213), re-designed for a
TPU input pipeline:

  - the collated batch is NHWC float32 (not NCHW float64->float32),
  - the one-hot seg_labels tensor is NOT materialized on the host; the
    jitted step builds it on device from the int mask (3x less host->device
    traffic at 512x512),
  - batches are produced by a background prefetch thread so augmentation
    overlaps with device compute (the reference uses fork'd DataLoader
    workers; this machine has a single core, so overlap is what matters),
  - randomness is per-(seed, epoch, index) — reproducible under any
    scheduling, unlike torch's per-worker global seeds.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from unet_embroidery_seg_torch.data.augment import letterbox, random_augment
from unet_embroidery_seg_torch.data.sources import class_index_from_label


@dataclass
class Batch:
    """One collated host batch (NHWC f32 images in [0,1], int32 masks)."""

    images: np.ndarray  # (N, H, W, 3) float32
    pngs: np.ndarray  # (N, H, W) int32, values in [0, num_classes]
    cls_labels: np.ndarray | None = None  # (N,) int32 (multitask only)


class SegmentationDataset:
    """Applies augmentation + label encoding on top of a raw sample source."""

    def __init__(
        self,
        source,
        input_shape: tuple[int, int],
        num_classes: int,
        augmentation: bool = True,
        task: str = "multiclass",
        return_cls_label: bool = False,
        seed: int = 11,
    ):
        self.source = source
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.augmentation = augmentation
        self.task = task
        self.return_cls_label = return_cls_label
        self.seed = seed

    def __len__(self) -> int:
        return len(self.source)

    def get(self, index: int, epoch: int = 0):
        sample = self.source[index]
        jpg, png = sample["image"], sample["mask"]
        if self.augmentation:
            rng = np.random.default_rng((self.seed, epoch, int(index)))
            jpg, png = random_augment(jpg, png, self.input_shape, rng)
            jpg = np.asarray(jpg, np.float32) / 255.0
        else:
            jpg, png = letterbox(jpg, png, self.input_shape)
            jpg = np.asarray(jpg, np.float32) / 255.0

        png = np.array(png)
        if self.task == "binary":
            png = (png > 0).astype(np.int32)
        else:
            png = png.astype(np.int32)
        # labels >= num_classes become the ignore class (hf_dataloader.py:87)
        png = np.where(png >= self.num_classes, self.num_classes, png)

        if self.return_cls_label:
            cls_label = class_index_from_label(str(sample.get("label", "unknown")))
            return jpg, png, cls_label
        return jpg, png, None

    def __getitem__(self, index: int):
        return self.get(index, epoch=0)


def collate(items: list, band: slice | None = None) -> Batch:
    """One batch of decoded items; ``band``: only those image rows."""
    rows = slice(None) if band is None else band
    images = np.stack([it[0][rows] for it in items]).astype(np.float32)
    pngs = np.stack([it[1][rows] for it in items]).astype(np.int32)
    cls = None
    if items[0][2] is not None:
        cls = np.asarray([it[2] for it in items], np.int32)
    return Batch(images=images, pngs=pngs, cls_labels=cls)


class DataLoader:
    """Epoch iterator with shuffling, padding-free batching and prefetch.

    ``drop_last=False`` like the reference; the final partial batch is
    padded up to ``batch_size`` by *repeating* samples, with ``valid`` counts
    carried so losses/metrics can mask the padding — TPU programs want static
    shapes, so variable-size tail batches would force a recompile.

    Under data parallelism (``world_size`` ranks) ``batch_size`` is the
    global batch: every rank walks the same seeded order and decodes only
    its contiguous ``rows`` of each padded global batch; ``n_valid`` stays
    the global batch's count. ``band`` (the mesh's space axis): the ranks
    of one data index decode the same rows and each keeps its band of the
    image rows.
    """

    def __init__(
        self,
        dataset: SegmentationDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 11,
        prefetch: int = 2,
        pad_final_batch: bool = True,
        rank: int = 0,
        world_size: int = 1,
        band: slice | None = None,
    ):
        if batch_size % world_size:
            raise ValueError(f"batch size {batch_size} must divide the data axis ({world_size})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.pad_final_batch = pad_final_batch
        b = batch_size // world_size
        self.rows = slice(rank * b, (rank + 1) * b)
        self.band = band

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[tuple[Batch, int]]:
        """Yield (batch, n_valid) pairs for one epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)

        def producer(q: queue.Queue):
            try:
                for start in range(0, n, self.batch_size):
                    idxs = order[start : start + self.batch_size]
                    n_valid = len(idxs)
                    if self.pad_final_batch and n_valid < self.batch_size:
                        reps = -(-self.batch_size // n_valid)
                        idxs = np.tile(idxs, reps)[: self.batch_size]
                    items = [self.dataset.get(int(i), epoch) for i in idxs[self.rows]]
                    q.put((collate(items, self.band), n_valid))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        t = threading.Thread(target=producer, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
