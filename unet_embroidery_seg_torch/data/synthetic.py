"""Seeded synthetic predict and train inputs that need no image library."""

from __future__ import annotations

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
