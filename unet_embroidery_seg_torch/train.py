"""Training CLI (port of the repo-root ``train.py``): the binary task.

``python -m unet_embroidery_seg_torch.train --data-path DIR --task binary --model unet_resnet50``

The argparse surface of ``train.py`` plus ``--device`` (default ``cuda``;
raises without a card, ``cpu`` runs the kernels' plain versions). This
slice trains ``--task binary`` with ``--model`` unet_resnet50, unet_plain,
attention_unet or dualdense_unet on the host input pipeline, with the diff
head, bf16 autocast (``--amp``, the default)
and Adam over float32 masters. It writes what ``scripts/make_tables.py``
and ``run.sh`` read, under ``run/train/expN``: ``config.json`` (with
``resolved_pos_weight``), ``summary.json``, ``test_metrics.json``,
``val_metrics_history.{json,csv}``, and ``weights/`` with ``best.pth`` and
``last.pth`` (model-only, the reference's format) and ``resume.pth`` (full
state, every ``--ckpt-every`` epochs, for ``--resume``).

Not in this slice, each raising ``NotImplementedError`` naming its ROADMAP
item: the multiclass and multitask tasks, ``multitask_unet``,
``--device-augment`` (the device-resident input path), ``--mesh-data`` /
``--mesh-space`` above 1 (multi-GPU), ``--profile`` (tooling) and
``--export-vis`` (curves and ``vis/``, off by default here).
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import shutil
import time
import traceback

import numpy as np

from unet_embroidery_seg_torch.data.dataset import DataLoader, SegmentationDataset
from unet_embroidery_seg_torch.data.sources import open_source
from unet_embroidery_seg_torch.engine import checkpoint, steps
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.ops import metrics as M
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.predict import resolve_amp_default
from unet_embroidery_seg_torch.utils.device import resolve_device
from unet_embroidery_seg_torch.utils.exp_folder import create_exp_folder
from unet_embroidery_seg_torch.utils.seeding import seed_everything

NOT_PORTED = {
    "task": "ROADMAP.md Queue 1 item 8 (multiclass and multitask tasks)",
    "model": "ROADMAP.md Queue 1 item 8 (multitask model and task)",
    "device_augment": "ROADMAP.md Queue 1 item 9 (device-resident input path)",
    "mesh": "ROADMAP.md Queue 1 item 10 (multi-GPU)",
    "profile": "ROADMAP.md Queue 1 item 11 (tooling)",
    "export_vis": "ROADMAP.md Queue 1 item 6 (curves and vis/, a later slice)",
}

TRAINED_MODELS = ("unet_resnet50", "unet_plain", "attention_unet", "dualdense_unet")


class LogColor:
    GREEN = "\033[1;32m"
    YELLOW = "\033[1;33m"
    RED = "\033[1;31m"
    RESET = "\033[0m"


def check_supported(args) -> None:
    """Raise ``NotImplementedError`` for what this slice does not train."""
    if args.task != "binary":
        raise NotImplementedError(f"--task {args.task} is not ported yet: {NOT_PORTED['task']}")
    if args.model not in TRAINED_MODELS:
        raise NotImplementedError(f"--model {args.model} is not ported yet: {NOT_PORTED['model']}")
    if args.device_augment:
        raise NotImplementedError(f"--device-augment is not ported yet: {NOT_PORTED['device_augment']}")
    if (args.mesh_data or 1) != 1 or args.mesh_space != 1:
        raise NotImplementedError(f"--mesh-data/--mesh-space > 1: {NOT_PORTED['mesh']}")
    if args.profile:
        raise NotImplementedError(f"--profile is not ported yet: {NOT_PORTED['profile']}")
    if args.export_vis:
        raise NotImplementedError(f"--export-vis is not ported yet: {NOT_PORTED['export_vis']}")


def estimate_pos_weight(train_dataset, n_samples: int) -> float | None:
    """Auto pos_weight = neg/pos over <= n linspace-sampled augmented items."""
    total_pos = 0
    total_neg = 0
    n = min(n_samples, len(train_dataset))
    for i in np.linspace(0, len(train_dataset) - 1, n, dtype=int):
        _, png, _ = train_dataset.get(int(i), epoch=0)
        total_pos += int((png == 1).sum())
        total_neg += int((png == 0).sum())
    if total_pos > 0:
        pw = total_neg / total_pos
        print(f"[pos_weight auto] neg/pos = {pw:.4f} (samples={n})")
        return pw
    return None


def host_batches(loader: DataLoader, epoch: int):
    """(images, pngs, sample_mask, n_valid) per batch of one epoch."""
    for batch, n_valid in loader.epoch(epoch):
        sm = (np.arange(loader.batch_size) < n_valid).astype(np.float32)
        yield batch.images, batch.pngs, sm, n_valid


def print_train_header():
    print(
        f"{LogColor.GREEN}Epoch{LogColor.RESET}{' ' * 12}"
        f"{LogColor.YELLOW}data_num{LogColor.RESET}{' ' * 12}"
        f"{LogColor.YELLOW}Loss{LogColor.RESET}{' ' * 12}"
        f"{LogColor.YELLOW}LR{LogColor.RESET}{' ' * 12}"
        f"{LogColor.YELLOW}Image_size{LogColor.RESET}{' ' * 12}"
        f"{LogColor.YELLOW}img/s{LogColor.RESET}"
    )


def print_train_row(epoch, train_epoch, it, n_batches, loss, lr, size, ips):
    e = f"{epoch + 1}/{train_epoch}"
    b = f"{it + 1}/{n_batches}"
    lo = f"{loss:.8f}"
    lrs = f"{lr:.8f}"
    print(
        f"\r{e}{' ' * (len('Epoch') + 12 - len(e))}"
        f"{b}{' ' * (len('data_num') + 12 - len(b))}"
        f"{lo}{' ' * (len('Loss') + 12 - len(lo))}"
        f"{lrs}{' ' * (len('LR') + 12 - len(lrs))}"
        f"{size}{' ' * (len('Image_size') + 12 - len(str(size)))}"
        f"{ips:.1f}",
        end="",
        flush=True,
    )


def run_eval(eval_step, loader: DataLoader, max_batches: int | None) -> dict:
    """Binary metrics from summed confusion counts, and the mean batch loss."""
    total_loss, seen = 0.0, 0
    counts = np.zeros(4, np.int64)
    for it, (images, pngs, sm, _) in enumerate(host_batches(loader, 0)):
        if max_batches and it >= max_batches:
            break
        loss, c = eval_step(images, pngs, sm)
        total_loss += float(loss)
        counts += c.cpu().numpy()
        seen += 1
    out = M.binary_metrics_from_counts(*counts)
    out["Loss"] = total_loss / max(seen, 1)
    return out


def write_history(exp_folder: str, val_metrics_history: list[dict]) -> None:
    with open(os.path.join(exp_folder, "val_metrics_history.json"), "w", encoding="utf-8") as f:
        json.dump(val_metrics_history, f, ensure_ascii=False, indent=2)
    fieldnames = ["epoch"]
    for m in val_metrics_history:
        fieldnames += [k for k in m if k not in fieldnames]
    with open(os.path.join(exp_folder, "val_metrics_history.csv"), "w", newline="",
              encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        for i, m in enumerate(val_metrics_history, start=1):
            writer.writerow({"epoch": i, **m})


def train(args) -> str:
    check_supported(args)
    device = resolve_device(args.device)
    if args.amp is None:
        args.amp = resolve_amp_default(args.model, args.loss, args.task)
    generator = seed_everything(args.seed)
    num_classes = 2
    train_epoch = args.epochs
    batch_size = args.batch_size

    exp_folder, weights_folder = create_exp_folder()
    os.makedirs(args.cache_dir, exist_ok=True)
    input_shape = [args.input_size, args.input_size]
    config_path = os.path.join(exp_folder, "config.json")
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(vars(args), f, ensure_ascii=False, indent=2)

    print(f"Loading HF Dataset from: {args.data_path}, config: {args.data_config}")

    def make_ds(split, augmentation):
        source = open_source(args.data_path, args.data_config, split, args.cache_dir)
        return SegmentationDataset(source, input_shape, num_classes, augmentation=augmentation,
                                   task="binary", seed=args.seed)

    train_dataset = make_ds("train", True)
    val_dataset = make_ds("validation", False)
    print(f"Train samples: {len(train_dataset)}, Val samples: {len(val_dataset)}")
    train_loader = DataLoader(train_dataset, batch_size, shuffle=True, seed=args.seed,
                              prefetch=args.workers)
    val_loader = DataLoader(val_dataset, batch_size, shuffle=False, seed=args.seed,
                            prefetch=args.workers)

    # Binary training uses the diff head: the model emits the (N, H, W) logit
    # difference the binary loss and metrics consume; same parameters.
    model = build_model(args.model, num_classes, decoder_width=args.decoder_width,
                        diff_head=True, generator=generator, device=device)
    if args.weights:
        if os.path.exists(args.weights):
            checkpoint.restore_flexible(args.weights, model)
        else:
            print(f"[WARN] weights not found: {args.weights}; training from scratch")

    init_lr_fit, min_lr_fit = schedules.resolve_init_lrs(batch_size, init_lr=args.lr)
    optimizer = schedules.make_train_optimizer(model.parameters(), init_lr_fit,
                                               momentum=args.momentum,
                                               weight_decay=args.weight_decay)
    lr_scheduler_func = schedules.get_lr_scheduler("cos", init_lr_fit, min_lr_fit, train_epoch)

    pw_flag = args.pos_weight if args.pos_weight is not None else "auto"
    pos_weight = None
    if args.loss == "bce" and pw_flag:
        pos_weight = (estimate_pos_weight(train_dataset, args.pos_weight_samples)
                      if pw_flag == "auto" else float(pw_flag))
    if pos_weight is not None:
        # 'auto' is data-dependent: record the value val.py needs.
        with open(config_path, "w", encoding="utf-8") as f:
            json.dump({**vars(args), "resolved_pos_weight": pos_weight}, f,
                      ensure_ascii=False, indent=2)

    max_train_batches = args.max_train_batches or None
    max_val_batches = args.max_val_batches or None
    max_test_batches = args.max_test_batches or None
    train_step = steps.make_binary_train_step(model, optimizer, args.loss, pos_weight,
                                              amp=args.amp)
    eval_step = steps.make_binary_eval_step(model, args.loss, pos_weight, amp=args.amp)

    start_time = time.time()
    best_score, best_epoch, best_val_metrics = -1.0, None, None
    deferred_best = None  # --defer-ckpt: a copy of the best weights on the device
    best_model_path = os.path.join(weights_folder, "best.pth")
    last_model_path = os.path.join(weights_folder, "last.pth")
    train_losses: list[float] = []
    val_losses: list[float] = []
    val_metrics_history: list[dict] = []
    step = 0

    start_epoch = 0
    if args.resume:
        if not os.path.exists(args.resume):
            raise FileNotFoundError(f"--resume checkpoint not found: {args.resume}")
        step, extra = checkpoint.restore_state(args.resume, model, optimizer)
        start_epoch = int(extra.get("epoch", 0))
        best_score = float(extra.get("best_score", -1.0))
        best_epoch = extra.get("best_epoch")
        best_val_metrics = extra.get("best_val_metrics")
        train_losses = list(extra.get("train_losses", []))
        val_losses = list(extra.get("val_losses", []))
        val_metrics_history = list(extra.get("val_metrics_history", []))
        if extra.get("seed") is not None and int(extra["seed"]) != args.seed:
            print(f"[WARN] resume checkpoint was trained with seed {extra['seed']}, "
                  f"current run uses {args.seed}; data order/augmentation will differ")
        # Carry the previous run's best/last weights into this exp folder so
        # the test evaluation works even if no new best is found.
        for name, dst in (("best.pth", best_model_path), ("last.pth", last_model_path)):
            src = os.path.join(os.path.dirname(args.resume), name)
            if os.path.exists(src):
                shutil.copyfile(src, dst)
        print(f"[resume] restored {args.resume}: starting at epoch "
              f"{start_epoch + 1}/{train_epoch}, best={best_score:.4f}")

    for epoch in range(start_epoch, train_epoch):
        lr_now = lr_scheduler_func(epoch)
        schedules.set_learning_rate(optimizer, lr_now)
        print_train_header()
        epoch_loss, seen, images_done = 0.0, 0, 0
        t_epoch = time.time()
        for it, (images, pngs, sm, n_valid) in enumerate(host_batches(train_loader, epoch)):
            if max_train_batches and it >= max_train_batches:
                break
            loss_val = float(train_step(images, pngs, sm))
            step += 1
            epoch_loss += loss_val
            seen += 1
            images_done += n_valid
            ips = images_done / max(time.time() - t_epoch, 1e-6)
            print_train_row(epoch, train_epoch, it, len(train_loader), loss_val, lr_now,
                            args.input_size, ips)
        print(LogColor.RESET)
        train_losses.append(epoch_loss / max(seen, 1))

        metrics = run_eval(eval_step, val_loader, max_val_batches)
        current_score = float(metrics["IoU"])
        val_losses.append(metrics["Loss"])
        val_metrics_history.append(metrics)
        if current_score > best_score:
            best_score, best_epoch, best_val_metrics = current_score, epoch + 1, metrics
            if args.defer_ckpt:
                deferred_best = {k: v.detach().clone() for k, v in model.state_dict().items()}
            else:
                checkpoint.save_weights(best_model_path, model)
            print(f"New best model saved with score: {best_score:.4f}")
        if not args.defer_ckpt:
            checkpoint.save_weights(last_model_path, model)
        if args.ckpt_every and (epoch + 1) % args.ckpt_every == 0:
            checkpoint.save_state(
                os.path.join(weights_folder, "resume.pth"), model, optimizer, step,
                extra={
                    "epoch": epoch + 1, "seed": args.seed, "best_score": best_score,
                    "best_epoch": best_epoch, "best_val_metrics": best_val_metrics,
                    "train_losses": train_losses, "val_losses": val_losses,
                    "val_metrics_history": val_metrics_history,
                },
            )

    if args.defer_ckpt:
        if deferred_best is not None:
            checkpoint.save_weights(best_model_path, deferred_best)
        checkpoint.save_weights(last_model_path, model)

    total_time = time.time() - start_time
    print(f"Training completed in {datetime.timedelta(seconds=int(total_time))}")

    test_metrics = None
    try:  # keep artifact writing alive, like the reference
        test_source = open_source(args.data_path, args.data_config, "test", args.cache_dir)
        test_dataset = SegmentationDataset(test_source, input_shape, num_classes,
                                           augmentation=False, task="binary", seed=args.seed)
        test_loader = DataLoader(test_dataset, batch_size, shuffle=False, seed=args.seed,
                                 prefetch=2)
        checkpoint.load_weights(best_model_path, model)
        test_metrics = run_eval(eval_step, test_loader, max_test_batches)
        with open(os.path.join(exp_folder, "test_metrics.json"), "w", encoding="utf-8") as f:
            json.dump(test_metrics, f, ensure_ascii=False, indent=2)
    except Exception as e:  # noqa: BLE001 - reported with its traceback, run goes on
        traceback.print_exc()
        print(f"[WARN] Skip test evaluation: {e}")

    write_history(exp_folder, val_metrics_history)
    with open(os.path.join(exp_folder, "summary.json"), "w", encoding="utf-8") as f:
        json.dump({
            "best_epoch": best_epoch,
            "best_score": float(best_score),
            "best_val_metrics": best_val_metrics,
            "test_metrics": test_metrics,
            "best_model_path": best_model_path,
            "last_model_path": last_model_path,
        }, f, ensure_ascii=False, indent=2)
    return exp_folder


def parse_args(argv=None):
    import argparse

    boolopt = argparse.BooleanOptionalAction
    parser = argparse.ArgumentParser(description="U-Net Training with HF Dataset (PyTorch/CUDA port)")
    parser.add_argument("--weights", default="",
                        help="Path to pretrained weights (.pth state_dict): shape-matched partial load")
    parser.add_argument("--resume", default="",
                        help="Path to a resume.pth full-state checkpoint: restores params, "
                             "optimizer state, epoch counter, best tracking and metric history")
    parser.add_argument("--data-path", default="./hf_datasets/merged_dataset_v2",
                        help="Path to HF dataset directory, or 'synthetic[:N]'")
    parser.add_argument("--data-config", default="no-ai", choices=["full", "no-ai", "sam3"],
                        help="Dataset config to use")
    parser.add_argument("--task", default="binary", choices=["binary", "multiclass", "multitask"],
                        help="Segmentation task (this slice trains binary)")
    parser.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS),
                        help="Model architecture (this slice trains all but multitask_unet)")
    parser.add_argument("--decoder-width", default=1.0, type=float,
                        help="unet_resnet50 only: decoder width multiplier (1.0 = reference "
                             "decoder; checkpoints are width-specific)")
    parser.add_argument("--cls-loss-weight", default=1.0, type=float,
                        help="For multitask only: classification loss weight")
    parser.add_argument("--loss", default="lovasz_hinge",
                        choices=["bce", "lovasz_hinge", "ce", "focal"], help="Loss function")
    parser.add_argument("--pos-weight", default=None,
                        help="'auto' or a float: BCE positive-term weight. Default: auto")
    parser.add_argument("--pos-weight-samples", default=80, type=int)
    parser.add_argument("--use-dice", action=boolopt, default=True,
                        help="For multiclass only: add Dice loss")
    parser.add_argument("--num-classes", default=4, type=int,
                        help="For multiclass only: foreground classes (no background)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda raises without a card, cpu runs the "
                             "kernels' plain versions")
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--epochs", default=50, type=int, metavar="N")
    parser.add_argument("--input-size", default=512, type=int)
    parser.add_argument("--workers", default=4, type=int, metavar="N",
                        help="Prefetch depth of the host input pipeline")
    parser.add_argument("--lr", default=0.0001, type=float)
    parser.add_argument("--momentum", default=0.9, type=float, metavar="M")
    parser.add_argument("--wd", "--weight-decay", default=1e-4, type=float, metavar="W",
                        dest="weight_decay")
    parser.add_argument("--amp", action=boolopt, default=None,
                        help="bf16 autocast with f32 master params (default: on)")
    parser.add_argument("--seed", default=11, type=int)
    parser.add_argument("--cache-dir", default=".hf-cache/datasets")
    parser.add_argument("--export-vis", action=boolopt, default=False,
                        help="Loss/metric curves and vis/ grids: not ported yet (a later "
                             "slice), so off by default; turning it on raises")
    parser.add_argument("--vis-num", default=8, type=int)
    parser.add_argument("--vis-seed", default=0, type=int)
    parser.add_argument("--max-train-batches", default=0, type=int)
    parser.add_argument("--max-val-batches", default=0, type=int)
    parser.add_argument("--max-test-batches", default=0, type=int)
    parser.add_argument("--device-augment", action=boolopt, default=None,
                        help="Device-resident dataset + on-device augmentation: not ported "
                             "yet, so turning it on raises; the host pipeline runs")
    parser.add_argument("--scan-chunk", default=8, type=int,
                        help="Train steps per dispatch on the device-resident path (unused)")
    parser.add_argument("--defer-ckpt", action=boolopt, default=False,
                        help="Write best/last.pth once, after the training loop (best kept "
                             "as a copy on the device); default: every epoch")
    parser.add_argument("--ckpt-every", default=5, type=int,
                        help="Save the full resume state (params+optimizer) every N epochs "
                             "(0 = never); best/last stay model-only like the reference")
    parser.add_argument("--profile", action=boolopt, default=False,
                        help="Trace a few train steps: not ported yet")
    parser.add_argument("--profile-steps", default=4, type=int)
    parser.add_argument("--mesh-data", default=None, type=int,
                        help="Data-parallel size: one card in this slice")
    parser.add_argument("--mesh-space", default=1, type=int,
                        help="Spatial-parallel size: one card in this slice")
    args = parser.parse_args(argv)
    if args.pos_weight == "":
        args.pos_weight = None
    return args


if __name__ == "__main__":
    train(parse_args())
