"""Evaluation CLI (port of the repo-root ``val.py``): the three tasks, on the test split.

``python -m unet_embroidery_seg_torch.val --data-path DIR --weights run/train/exp/weights/best.pth``

Strict load of a model-only ``.pth`` (binary: into the standard two-channel
head), test-split evaluation one image at a time (the reference's batch
size 1), and the JAX CLI's report: binary, the Dice / IoU / Precision /
Recall / Accuracy row; multitask, seg IoU and Dice and the overall and
per-class classification accuracy (``--pos-weight``: the value the
checkpoint trained with, so the loss is on its scale); multiclass, the dict
of per-sample means (``--num-classes``). ``--device cuda`` (the default)
raises without a card; ``cpu`` runs the kernels' plain versions.

``--device-resident`` (the default on ``cuda``, as the JAX CLI's on an
accelerator; on the CPU only when asked) letterboxes the split once into
uint8 canvases, uploads them to the device and evaluates them there in
batches of ``--batch-size``, read from the device once: the same counts
(binary, multitask) and per-sample means (multiclass) as the host path.
"""

from __future__ import annotations

import os

import numpy as np

from unet_embroidery_seg_torch.data.cache import CanvasCache
from unet_embroidery_seg_torch.data.dataset import DataLoader, SegmentationDataset
from unet_embroidery_seg_torch.data.sources import CLASS_NAMES, open_source
from unet_embroidery_seg_torch.engine import checkpoint, resident, steps
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.ops import metrics as M
from unet_embroidery_seg_torch.predict import resolve_amp_default
from unet_embroidery_seg_torch.train import LogColor, read_once
from unet_embroidery_seg_torch.utils.device import resolve_device, set_float32_precision
from unet_embroidery_seg_torch.utils.seeding import seed_everything


def val(args) -> dict:
    device = resolve_device(args.device)
    set_float32_precision()
    os.makedirs(args.cache_dir, exist_ok=True)
    input_shape = [args.input_size, args.input_size]
    print(f"Loading HF Dataset from: {args.data_path}, config: {args.data_config}, split: test")
    source = open_source(args.data_path, args.data_config, "test", args.cache_dir)
    num_classes = 2 if args.task in ("binary", "multitask") else args.num_classes + 1
    multitask = args.task == "multitask"
    use_resident = args.device_resident
    if use_resident is None:
        use_resident = device.type == "cuda"
    if use_resident:
        cache = CanvasCache(source, tuple(input_shape), return_cls_label=multitask)
        print(f"Test samples: {len(cache)}")
    else:
        dataset = SegmentationDataset(source, input_shape, num_classes, augmentation=False,
                                      task="binary" if multitask else args.task,
                                      return_cls_label=multitask, seed=11)
        print(f"Test samples: {len(dataset)}")
        loader = DataLoader(dataset, batch_size=1, shuffle=False, prefetch=2)

    seed_everything(11)
    if args.amp is None:
        args.amp = resolve_amp_default(args.model, args.loss, args.task)
    model = build_model(args.model, num_classes, decoder_width=args.decoder_width, device=device)
    checkpoint.load_weights(args.weights, model)
    print(f"Model loaded from: {args.weights}")
    print("Starting evaluation...\n")

    def batches():
        for batch, n_valid in loader.epoch(0):
            mask = (np.arange(batch.images.shape[0]) < n_valid).astype(np.float32)
            yield batch, mask

    def resident_outs(eval_step):
        """The eval step's outputs over the whole split resident on the device, stacked per batch."""
        data = resident.upload(cache, device)
        chunk = resident.make_eval_chunk_fn(eval_step, binary=args.task != "multiclass",
                                            num_classes=num_classes, multitask=multitask)
        idx, maskp = resident.epoch_index_plan(data.n, args.batch_size, 0, False, 11)
        return chunk(data, *resident.upload_plan(idx, maskp, device))

    if multitask:
        pos_weight = float(args.pos_weight) if args.pos_weight else None
        eval_step = steps.make_multitask_eval_step(model, seg_loss_name=args.loss,
                                                   pos_weight=pos_weight, amp=args.amp)
        seg_counts = np.zeros(4, np.int64)
        confusion = np.zeros((3, 3), np.int64)
        total_loss, seen = 0.0, 0
        if use_resident:
            (loss, _, _), sc, cf = resident_outs(eval_step)
            loss, sc, cf = read_once(loss, sc.sum(0), cf.sum(0))
            seg_counts += sc.astype(np.int64)
            confusion += cf.astype(np.int64)
            total_loss, seen = float(loss.sum()), len(loss)
        else:
            for batch, mask in batches():
                (loss, _, _), sc, cf = eval_step(batch.images, batch.pngs, batch.cls_labels,
                                                 mask)
                seg_counts += sc.cpu().numpy()
                confusion += cf.cpu().numpy()
                total_loss += float(loss)
                seen += 1
        seg_m = M.multitask_seg_metrics_from_counts(*seg_counts)
        cls_acc = 100.0 * int(np.trace(confusion)) / max(int(confusion.sum()), 1)
        print("=" * 50)
        print(f"{LogColor.BLUE}Multi-Task Evaluation Results{LogColor.RESET}")
        print("=" * 50)
        print(f"\n{LogColor.RED}Segmentation Metrics:{LogColor.RESET}")
        print(f"  IoU:  {seg_m['IoU']:.4f}")
        print(f"  Dice: {seg_m['Dice']:.4f}")
        print(f"\n{LogColor.RED}Classification Metrics:{LogColor.RESET}")
        print(f"  Overall Accuracy: {cls_acc:.2f}%")
        print("\n  Per-Class Accuracy:")
        for i, name in enumerate(CLASS_NAMES):
            n_i = int(confusion[i].sum())
            if n_i > 0:
                print(f"    {name}: {100.0 * confusion[i, i] / n_i:.2f}% ({n_i} samples)")
        print("=" * 50)
        return {"Loss": total_loss / max(seen, 1), **seg_m, "Cls Acc": cls_acc}
    if args.task == "multiclass":
        # Per-SAMPLE sums at any batch size: the reference CLI's statistic
        # (batch size 1, per-batch metrics averaged), which batch-averaged
        # values at a larger batch would not give (class presence is per sample).
        eval_step = steps.make_multiclass_persample_eval_step(model, num_classes, use_dice=True,
                                                              amp=args.amp)
        sums: dict[str, float] = {}
        loss_sum, n_total = 0.0, 0.0
        if use_resident:
            ls, m, nv = resident_outs(eval_step)
            ls, nv, *values = read_once(ls, nv, *m.values())
            loss_sum, n_total = float(ls.sum()), float(nv.sum())
            sums = {k: float(v.sum()) for k, v in zip(m, values)}
        else:
            for batch, mask in batches():
                ls, m, nv = eval_step(batch.images, batch.pngs, mask)
                loss_sum += float(ls)
                n_total += float(nv)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        n_total = max(n_total, 1.0)
        metrics = {k: v / n_total for k, v in sums.items()}
        metrics["Loss"] = loss_sum / n_total
        print(metrics)
        return metrics

    eval_step = steps.make_binary_eval_step(model, args.loss, amp=args.amp)
    counts = np.zeros(4, np.int64)
    total_loss, seen = 0.0, 0
    if use_resident:
        loss, c = resident_outs(eval_step)
        loss, c = read_once(loss, c.sum(0))
        counts += c.astype(np.int64)
        total_loss, seen = float(loss.sum()), len(loss)
    else:
        for batch, mask in batches():
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
                        help="Segmentation task")
    parser.add_argument("--decoder-width", default=1.0, type=float,
                        help="unet_resnet50 only: must match the checkpoint's width")
    parser.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS))
    parser.add_argument("--loss", default="lovasz_hinge",
                        choices=["bce", "lovasz_hinge", "ce", "focal"])
    parser.add_argument("--num-classes", default=4, type=int)
    parser.add_argument("--pos-weight", default=None,
                        help="multitask only: the pos_weight the checkpoint was trained with "
                             "(config.json 'resolved_pos_weight'), so the reported loss is on "
                             "the training scale; numeric only")
    parser.add_argument("--input-size", default=512, type=int)
    parser.add_argument("--cache-dir", default=".hf-cache/datasets")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda raises without a card, cpu runs the "
                             "kernels' plain versions")
    parser.add_argument("--amp", action=argparse.BooleanOptionalAction, default=None,
                        help="bf16 compute (default: train's per-config rule)")
    parser.add_argument("--batch-size", default=8, type=int,
                        help="Eval batch size of the device-resident path (the host path "
                             "keeps the reference's batch size 1)")
    parser.add_argument("--device-resident", action=argparse.BooleanOptionalAction, default=None,
                        help="Evaluate from canvases resident on the device (default: on for "
                             "cuda, off for cpu)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    val(parse_args())
