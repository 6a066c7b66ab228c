"""Letterboxed uint8 canvases of a whole split (copy of ``unet_embroidery_seg_tpu/data/cache.py``).

Decodes and letterboxes every sample once (the expensive PIL work) and keeps
the uint8 canvases in host memory; ``engine/resident.py`` uploads them to
the card once, where ``ops/device_augment.py`` augments every batch. The
embroidery datasets are small (<= 584 train images), so a 512x512 uint8
split is ~460 MB. The host path (``data/dataset.py``) stays the semantics
reference.
"""

from __future__ import annotations

import numpy as np

from unet_embroidery_seg_torch.data.augment import letterbox
from unet_embroidery_seg_torch.data.sources import class_index_from_label


class CanvasCache:
    """uint8 letterboxed canvases for a whole split, built once."""

    def __init__(
        self,
        source,
        input_shape: tuple[int, int],
        return_cls_label: bool = False,
        verbose: bool = True,
    ):
        n = len(source)
        h, w = input_shape
        self.images = np.zeros((n, h, w, 3), np.uint8)
        self.masks = np.zeros((n, h, w), np.uint8)
        self.valid_wh = np.zeros((n, 2), np.float32)
        self.cls_labels = np.zeros((n,), np.int32) if return_cls_label else None
        for i in range(n):
            sample = source[i]
            img, msk = sample["image"], sample["mask"]
            iw, ih = img.size
            scale = min(w / iw, h / ih)
            nw, nh = int(iw * scale), int(ih * scale)
            canvas_img, canvas_mask = letterbox(img, msk, input_shape)
            self.images[i] = np.asarray(canvas_img, np.uint8)
            self.masks[i] = np.asarray(canvas_mask, np.uint8)
            self.valid_wh[i] = (nw, nh)
            if self.cls_labels is not None:
                self.cls_labels[i] = class_index_from_label(str(sample.get("label", "unknown")))
        if verbose:
            mb = (self.images.nbytes + self.masks.nbytes) / 2**20
            print(f"[cache] {n} samples letterboxed to {h}x{w} ({mb:.0f} MB host RAM)")

    def __len__(self) -> int:
        return len(self.images)
