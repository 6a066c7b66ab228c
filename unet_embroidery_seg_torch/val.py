"""Evaluation CLI (port of the repo-root ``val.py``): binary, on the test split.

``python -m unet_embroidery_seg_torch.val --data-path DIR --weights run/train/exp/weights/best.pth``

Strict load of a model-only ``.pth`` into the standard two-channel head,
test-split evaluation one image at a time (the reference's batch size 1),
and the Dice / IoU / Precision / Recall / Accuracy row. ``--device cuda``
(the default) raises without a card; ``cpu`` runs the kernels' plain
versions. The multiclass and multitask tasks and ``--device-resident``
raise ``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

import os

import numpy as np

from unet_embroidery_seg_torch.data.dataset import DataLoader, SegmentationDataset
from unet_embroidery_seg_torch.data.sources import open_source
from unet_embroidery_seg_torch.engine import checkpoint, steps
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.ops import metrics as M
from unet_embroidery_seg_torch.predict import resolve_amp_default
from unet_embroidery_seg_torch.train import NOT_PORTED, LogColor
from unet_embroidery_seg_torch.utils.device import resolve_device
from unet_embroidery_seg_torch.utils.seeding import seed_everything


def val(args) -> dict:
    if args.task != "binary":
        raise NotImplementedError(f"--task {args.task} is not ported yet: {NOT_PORTED['task']}")
    if args.device_resident:
        raise NotImplementedError(f"--device-resident is not ported yet: {NOT_PORTED['device_augment']}")
    device = resolve_device(args.device)
    os.makedirs(args.cache_dir, exist_ok=True)
    input_shape = [args.input_size, args.input_size]
    print(f"Loading HF Dataset from: {args.data_path}, config: {args.data_config}, split: test")
    source = open_source(args.data_path, args.data_config, "test", args.cache_dir)
    dataset = SegmentationDataset(source, input_shape, 2, augmentation=False, task="binary",
                                  seed=11)
    print(f"Test samples: {len(dataset)}")
    loader = DataLoader(dataset, batch_size=1, shuffle=False, prefetch=2)

    seed_everything(11)
    if args.amp is None:
        args.amp = resolve_amp_default(args.model, args.loss, args.task)
    model = build_model(args.model, 2, decoder_width=args.decoder_width, device=device)
    checkpoint.load_weights(args.weights, model)
    print(f"Model loaded from: {args.weights}")
    print("Starting evaluation...\n")

    eval_step = steps.make_binary_eval_step(model, args.loss, amp=args.amp)
    counts = np.zeros(4, np.int64)
    total_loss, seen = 0.0, 0
    for batch, n_valid in loader.epoch(0):
        mask = (np.arange(batch.images.shape[0]) < n_valid).astype(np.float32)
        loss, c = eval_step(batch.images, batch.pngs, mask)
        counts += c.cpu().numpy()
        total_loss += float(loss)
        seen += 1
    metrics = M.binary_metrics_from_counts(*counts)
    metrics["Loss"] = total_loss / max(seen, 1)
    print(
        f"{LogColor.RED}Dice{LogColor.RESET}\t"
        f"{LogColor.RED}IoU{LogColor.RESET}\t"
        f"{LogColor.RED}Precision{LogColor.RESET}\t"
        f"{LogColor.RED}Recall{LogColor.RESET}\t"
        f"{LogColor.RED}Accuracy{LogColor.RESET}"
    )
    print(
        f"{metrics['Dice']:.4f}\t{metrics['IoU']:.4f}\t"
        f"{metrics['Precision']:.4f}\t{metrics['Recall']:.4f}\t"
        f"{metrics['Accuracy']:.4f}"
    )
    return metrics


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="U-Net Validation with HF Dataset (PyTorch/CUDA port)")
    parser.add_argument("--data-path", default="./hf_datasets/merged_dataset_v2")
    parser.add_argument("--data-config", default="no-ai", choices=["full", "no-ai", "sam3"])
    parser.add_argument("--weights", default="run/train/exp/weights/best.pth")
    parser.add_argument("--task", default="binary", choices=["binary", "multiclass", "multitask"],
                        help="Segmentation task (this slice evaluates binary)")
    parser.add_argument("--decoder-width", default=1.0, type=float,
                        help="unet_resnet50 only: must match the checkpoint's width")
    parser.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS))
    parser.add_argument("--loss", default="lovasz_hinge",
                        choices=["bce", "lovasz_hinge", "ce", "focal"])
    parser.add_argument("--num-classes", default=4, type=int)
    parser.add_argument("--pos-weight", default=None,
                        help="multitask only (not ported yet): the pos_weight the checkpoint "
                             "was trained with")
    parser.add_argument("--input-size", default=512, type=int)
    parser.add_argument("--cache-dir", default=".hf-cache/datasets")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda raises without a card, cpu runs the "
                             "kernels' plain versions")
    parser.add_argument("--amp", action=argparse.BooleanOptionalAction, default=None,
                        help="bf16 compute (default: train's per-config rule)")
    parser.add_argument("--batch-size", default=8, type=int,
                        help="Eval batch size of the device-resident path (not ported; the "
                             "host path keeps the reference's batch size 1)")
    parser.add_argument("--device-resident", action=argparse.BooleanOptionalAction, default=None,
                        help="Evaluate from canvases resident on the card: not ported yet")
    return parser.parse_args(argv)


if __name__ == "__main__":
    val(parse_args())
