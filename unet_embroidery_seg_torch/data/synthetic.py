"""Seeded synthetic predict and train inputs that need no image library."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def letterboxed_canvases(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` random images of random aspect, letterboxed onto gray ``size``^2 canvases.

    The letterbox of ``data/augment.py`` (aspect-preserving bicubic resize,
    centred on gray 128) done with torch on the CPU instead of PIL. Returns
    NHWC float32 in [0, 1], the predict path's input.
    """
    rng = np.random.default_rng(seed)
    out = np.full((n, size, size, 3), 128 / 255, np.float32)
    for i in range(n):
        w, h = (int(v) for v in rng.integers(size // 2, 2 * size, 2))
        img = torch.from_numpy(rng.random((3, h, w), dtype=np.float32))[None]
        scale = min(size / w, size / h)
        nw, nh = int(w * scale), int(h * scale)
        img = F.interpolate(img, size=(nh, nw), mode="bicubic", align_corners=False)
        top, left = (size - nh) // 2, (size - nw) // 2
        out[i, top : top + nh, left : left + nw] = img[0].clamp(0, 1).permute(1, 2, 0).numpy()
    return out


def seeded_train_batch(batch: int, size: int, seed: int):
    """(images, pngs, sample_mask) of one train batch, all from ``seed``.

    Images are ``letterboxed_canvases``; each mask is one disc (a blob the
    model can learn) of ~5-30% of the canvas; every sample is valid.
    """
    images = letterboxed_canvases(batch, size, seed=seed)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    cx, cy, r = rng.uniform(0.2, 0.8, (3, batch, 1, 1))
    pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
    return images, pngs, np.ones(batch, np.float32)


def seeded_task_batch(batch: int, size: int, seed: int, task: str, num_classes: int = 5):
    """The step arguments of one seeded train batch for ``task``, all from ``seed``.

    binary: ``seeded_train_batch``'s (images, pngs, sample_mask).
    multiclass: the same, each disc labelled with a class in 1 .. num_classes - 1
    (0 is the background). multitask: (images, pngs, class labels in 0..2,
    sample_mask).
    """
    images, pngs, sm = seeded_train_batch(batch, size, seed)
    rng = np.random.default_rng((seed, 1))
    if task == "multiclass":
        labels = rng.integers(1, num_classes, (batch, 1, 1))
        return images, (pngs * labels).astype(np.int32), sm
    if task == "multitask":
        return images, pngs, rng.integers(0, 3, batch).astype(np.int32), sm
    return images, pngs, sm


@dataclass
class Canvases:
    """A split as ``data/cache.CanvasCache`` holds it: what ``engine/resident.upload`` reads."""

    images: np.ndarray  # (n, size, size, 3) uint8, letterboxed on gray 128
    masks: np.ndarray  # (n, size, size) uint8, 0 outside the content
    valid_wh: np.ndarray  # (n, 2) float32: the letterboxed content's (nw, nh)
    cls_labels: np.ndarray | None  # (n,) int32 in 0..2, or None

    def __len__(self) -> int:
        return len(self.images)


def resident_canvases(n: int, size: int, seed: int, mask_classes: int = 1,
                      cls_labels: bool = False) -> Canvases:
    """A seeded resident split of ``n`` canvases, built without PIL.

    Each sample is a random-aspect image (``letterboxed_canvases``' draw:
    noise) with one disc of a flat random colour, labelled 1 .. mask_classes
    in its mask; both are letterboxed onto ``size``^2 canvases as
    ``CanvasCache`` letterboxes (image bicubic on gray 128, mask nearest on
    0), and the content's (nw, nh) computed as it computes them.
    """
    rng = np.random.default_rng(seed)
    images = np.full((n, size, size, 3), 128, np.uint8)
    masks = np.zeros((n, size, size), np.uint8)
    valid_wh = np.zeros((n, 2), np.float32)
    for i in range(n):
        w, h = (int(v) for v in rng.integers(size // 2, 2 * size, 2))
        img = rng.random((3, h, w), dtype=np.float32)
        yy, xx = np.mgrid[:h, :w]
        cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
        r = rng.uniform(0.1, 0.35) * min(w, h)
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img[:, disc] = rng.random((3, 1), dtype=np.float32)
        label = int(rng.integers(1, mask_classes + 1))
        scale = min(size / w, size / h)
        nw, nh = int(w * scale), int(h * scale)
        top, left = (size - nh) // 2, (size - nw) // 2
        img_t = F.interpolate(torch.from_numpy(img)[None], size=(nh, nw), mode="bicubic",
                              align_corners=False)[0].clamp(0, 1)
        images[i, top : top + nh, left : left + nw] = (
            (img_t.permute(1, 2, 0) * 255.0).round().to(torch.uint8).numpy())
        m = torch.from_numpy(disc.astype(np.float32))[None, None]
        m = F.interpolate(m, size=(nh, nw), mode="nearest")[0, 0].numpy() > 0
        masks[i, top : top + nh, left : left + nw] = m * label
        valid_wh[i] = (nw, nh)
    cls = rng.integers(0, 3, n).astype(np.int32) if cls_labels else None
    return Canvases(images, masks, valid_wh, cls)
