"""Qualitative 2x2 prediction grids for a fixed-seed sample of the test set.

Port of ``unet_embroidery_seg_tpu/utils/vis_export.py`` onto the port's
``engine.steps.make_predict_fn``. ``vis/indices.json`` lists the sampled
indices, and each sample gets one ``NNNN_<stem>_grid.png`` laid out as

    [ original image | ground truth in red  ]
    [ prediction in green | 0.5-alpha overlay ]

on the letterboxed input. PIL is imported inside the function.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import torch

from unet_embroidery_seg_torch.data.augment import letterbox


def _tint(binary: np.ndarray, channel: int) -> np.ndarray:
    """{0,1} mask -> RGB with the foreground painted on one channel."""
    rgb = np.zeros(binary.shape + (3,), np.uint8)
    rgb[..., channel] = np.where(binary > 0, 255, 0).astype(np.uint8)
    return rgb


def render_grid(image_u8: np.ndarray, gt01: np.ndarray, pred01: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Assemble the 2x2 panel as one uint8 array."""
    gt_panel = _tint(gt01, channel=0)  # red
    pred_panel = _tint(pred01, channel=1)  # green
    blend = np.clip(image_u8 * (1.0 - alpha) + pred_panel * alpha, 0, 255).astype(np.uint8)
    top = np.concatenate([image_u8, gt_panel], axis=1)
    bottom = np.concatenate([pred_panel, blend], axis=1)
    return np.concatenate([top, bottom], axis=0)


def export_binary_visuals(
    predict_fn,
    source,
    out_dir: str,
    input_shape: tuple[int, int],
    num_samples: int = 8,
    seed: int = 0,
    multitask: bool = False,
) -> None:
    """Write grids for up to ``num_samples`` samples chosen by ``seed``.

    ``predict_fn``: ``make_predict_fn`` of a binary or multitask model. The
    prediction: the argmax of two-channel NHWC logits, or ``diff > 0`` of a
    diff-head model's (N, H, W) logit difference (the same but where the two
    logits tie), or multitask's seg logit > 0.
    """
    from PIL import Image

    folder = Path(out_dir)
    folder.mkdir(parents=True, exist_ok=True)

    k = min(num_samples, len(source))
    chosen = random.Random(seed).sample(range(len(source)), k=k) if k else []
    (folder / "indices.json").write_text(json.dumps(chosen, ensure_ascii=False, indent=2),
                                         encoding="utf-8")

    for idx in chosen:
        record = source[idx]
        img_pil, mask_pil = letterbox(record["image"], record["mask"], input_shape)
        image_u8 = np.asarray(img_pil, np.uint8)
        gt01 = (np.asarray(mask_pil) > 0).astype(np.uint8)

        batch = torch.from_numpy(image_u8.astype(np.float32))[None] / 255.0
        out = predict_fn(batch)
        if multitask:
            pred = out[0][0, ..., 0] > 0
        else:
            pred = out[0] > 0 if out.dim() == 3 else out[0].argmax(-1)
        pred01 = pred.to(torch.uint8).cpu().numpy()

        stem = Path(str(record.get("filename") or f"sample_{idx}")).stem
        Image.fromarray(render_grid(image_u8, gt01, pred01)).save(
            folder / f"{idx:04d}_{stem}_grid.png")
