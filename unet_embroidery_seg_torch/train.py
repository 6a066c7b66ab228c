"""Training CLI (port of the repo-root ``train.py``): the binary, multiclass and multitask tasks.

``python -m unet_embroidery_seg_torch.train --data-path DIR --task binary --model unet_resnet50``

The argparse surface of ``train.py`` plus ``--device`` (default ``cuda``;
raises without a card, ``cpu`` runs the kernels' plain versions). Tasks, as
the JAX CLI:

- ``binary`` with unet_resnet50, unet_plain, attention_unet or
  dualdense_unet, through the diff head; BCE (``pos_weight`` auto by
  default) or the Lovasz hinge;
- ``multiclass`` with the same four models and ``--num-classes + 1``
  output channels (the last is the ignore class of the targets); CE or
  focal (``--loss focal``), plus Dice (``--use-dice``); ``bce`` and
  ``lovasz_hinge`` are lowered to CE with a warning; the best epoch by
  Mean IoU;
- ``multitask`` with multitask_unet only (either pairing off raises):
  binary seg masks and 3-way class labels, seg BCE (``pos_weight`` OFF
  unless ``--pos-weight auto|<float>``, as the reference never weights it)
  or Lovasz, plus ``--cls-loss-weight`` times the class CE; the best epoch
  by seg IoU.

bf16 autocast (``--amp``, the default) or f32 (``--no-amp``), Adam over
float32 masters. Two input paths, as in the JAX CLI:

- the device-resident path (``--device-augment``, the default on ``cuda``):
  every split letterboxed once into uint8 canvases (``data/cache.py``),
  uploaded to the card once, augmented there (``ops/device_augment.py``),
  in chunks of ``--scan-chunk`` steps whose losses are read once per chunk
  (``engine/resident.py``); on the CPU only when asked
  (``--device-augment --device cpu``);
- the host pipeline (``--no-device-augment``, the default on the CPU):
  PIL/cv2 augmentation per sample, one batch copied per step.

It writes what ``scripts/make_tables.py`` and ``run.sh`` read, under
``run/train/expN``, keyed as the JAX CLI keys them: ``config.json`` (with
``resolved_pos_weight``), ``summary.json``, ``test_metrics.json``,
``val_metrics_history.{json,csv}``, ``weights/`` with ``best.pth`` and
``last.pth`` (model-only, the reference's format), ``resume.pth`` (full
state, every ``--ckpt-every`` epochs, for ``--resume``) and the
``loss_curve.png`` / ``metrics_curve.png`` curves, and with
``--export-vis`` (the default) ``vis/`` grids of the test split.

Data parallelism (the JAX mesh's ``data`` axis, ``parallel/mesh.py``):
``--mesh-data N`` trains on N ranks, each on its own card (NCCL) or, with
``--device cpu``, its own process (gloo). The plain command starts N local
worker processes; under ``torchrun --nproc-per-node N -m
unet_embroidery_seg_torch.train ...`` each process joins the job. The
default follows the JAX CLI: every visible card on ``cuda`` (one process
per card), one process on the CPU. ``--batch-size`` is the global batch and
must divide the data axis; each rank takes its rows of every global batch,
and the losses, metrics and BatchNorm statistics are the global batch's.
Rank 0 makes ``expN`` and writes every file and print; the checkpoints
hold the model's own keys (no DDP ``module.`` prefix).

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``--mesh-space`` above 1 (the spatial axis) and ``--profile``
(tooling).
"""

from __future__ import annotations

import contextlib
import copy
import csv
import datetime
import json
import os
import shutil
import time
import traceback

import numpy as np
import torch

from unet_embroidery_seg_torch.data.cache import CanvasCache
from unet_embroidery_seg_torch.data.dataset import DataLoader, SegmentationDataset
from unet_embroidery_seg_torch.data.sources import open_source
from unet_embroidery_seg_torch.engine import checkpoint, resident, steps
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.ops import metrics as M
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.parallel import mesh as mesh_lib
from unet_embroidery_seg_torch.predict import resolve_amp_default
from unet_embroidery_seg_torch.utils.device import resolve_device, set_float32_precision
from unet_embroidery_seg_torch.utils.exp_folder import create_exp_folder
from unet_embroidery_seg_torch.utils.plotting import plot_training_curves
from unet_embroidery_seg_torch.utils.seeding import seed_everything
from unet_embroidery_seg_torch.utils.vis_export import export_binary_visuals

NOT_PORTED = {
    "mesh_space": mesh_lib.SPACE_NOT_PORTED,
    "profile": "ROADMAP.md Queue 1 item 11 (tooling)",
}


class LogColor:
    GREEN = "\033[1;32m"
    YELLOW = "\033[1;33m"
    RED = "\033[1;31m"
    RESET = "\033[0m"
    BLUE = "\033[1;34m"


def check_supported(args) -> None:
    """Refuse a task/model mismatch; raise ``NotImplementedError`` for what is not ported yet."""
    # The reference only surfaces a mismatch as an unpack error deep in its
    # epoch loop; the JAX CLI refuses it up front, and so does this one.
    if (args.task == "multitask") != (args.model == "multitask_unet"):
        raise SystemExit(
            f"--task {args.task} is incompatible with --model {args.model}: "
            "multitask training requires the two-headed multitask_unet "
            "(and multitask_unet only trains under --task multitask)"
        )
    if args.mesh_space != 1:
        raise NotImplementedError(f"--mesh-space > 1: {NOT_PORTED['mesh_space']}")
    if args.profile:
        raise NotImplementedError(f"--profile is not ported yet: {NOT_PORTED['profile']}")


def resolve_mesh_data(args, device: torch.device) -> int:
    """The data axis's size: ``--mesh-data``, else as the JAX CLI (all devices).

    Under ``torchrun``, the job's processes; on ``cuda`` (no card index
    given), every visible card; on the CPU, 1. Raises, as the JAX CLI, for
    more cards than there are and for a batch that does not divide the axis.
    """
    if args.mesh_data is not None:
        n = args.mesh_data
    elif mesh_lib.in_job():
        n = int(os.environ.get("WORLD_SIZE", "1"))
    elif device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
    else:
        n = 1
    if device.type == "cuda" and not mesh_lib.in_job():
        mesh_lib.check_mesh_size(n, args.mesh_space, torch.cuda.device_count())
    if args.batch_size % n:
        raise ValueError(f"batch size {args.batch_size} must divide the data axis ({n}); "
                         "adjust --batch-size or --mesh-data")
    return n


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


def resolve_num_classes(args) -> int:
    """Output classes of the seg task: 2 for binary and multitask, ``--num-classes + 1`` else."""
    if args.task in ("binary", "multitask"):
        return 2
    return args.num_classes + 1


def resolve_pos_weight(args, train_dataset) -> float | None:
    """The seg BCE's ``pos_weight``: auto (neg/pos) by default for binary BCE, off for multitask.

    ``--pos-weight auto|<float>`` turns it on for multitask too, where it
    applies to every seg loss but the Lovasz hinge; multiclass has none.
    """
    pw_flag = args.pos_weight
    if pw_flag is None:
        pw_flag = "auto" if args.task == "binary" else ""
    applies = ((args.task == "binary" and args.loss == "bce")
               or (args.task == "multitask" and args.loss != "lovasz_hinge"))
    if not (applies and pw_flag):
        return None
    if pw_flag == "auto":
        return estimate_pos_weight(train_dataset, args.pos_weight_samples)
    return float(pw_flag)


def host_batches(loader: DataLoader, epoch: int):
    """(images, pngs, cls_labels or None, sample_mask, n_valid) per batch of one epoch.

    This rank's rows and their sample mask; ``n_valid`` is the global batch's.
    """
    for batch, n_valid in loader.epoch(epoch):
        sm = (np.arange(loader.batch_size) < n_valid).astype(np.float32)[loader.rows]
        yield batch.images, batch.pngs, batch.cls_labels, sm, n_valid


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


def read_once(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The tensors on the host in one copy from the card (float64, exact for counts < 2^53)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def split_metrics(task: str, total_loss: float, seen: int, counts: np.ndarray,
                  confusion: np.ndarray, mc_sums: dict[str, float]) -> dict:
    """One split's metrics, keyed as the JAX CLI keys them, and the mean batch loss.

    binary: from summed confusion counts. multitask: seg IoU and Dice from
    summed counts, Cls Acc (%) from the summed confusion. multiclass: the
    mean over batches of each batch's metrics (the reference's statistic).
    """
    seen = max(seen, 1)
    if task == "binary":
        out = M.binary_metrics_from_counts(*counts)
        out["Loss"] = total_loss / seen
        return out
    if task == "multitask":
        seg = M.multitask_seg_metrics_from_counts(*counts)
        return {"Loss": total_loss / seen, "IoU": seg["IoU"], "Dice": seg["Dice"],
                "Cls Acc": 100.0 * int(np.trace(confusion)) / max(int(confusion.sum()), 1)}
    out = {k: v / seen for k, v in mc_sums.items()}
    out["Loss"] = total_loss / seen
    return out


def run_eval(eval_step, loader: DataLoader, max_batches: int | None, task: str) -> dict:
    """``split_metrics`` of the host-fed eval over ``loader``, one batch copied per step."""
    total_loss, seen = 0.0, 0
    counts = np.zeros(4, np.int64)
    confusion = np.zeros((3, 3), np.int64)
    mc_sums: dict[str, float] = {}
    for it, (images, pngs, cls, sm, _) in enumerate(host_batches(loader, 0)):
        if max_batches and it >= max_batches:
            break
        if task == "multitask":
            (loss, _, _), c, cf = eval_step(images, pngs, cls, sm)
            confusion += cf.cpu().numpy()
        elif task == "binary":
            loss, c = eval_step(images, pngs, sm)
        else:
            loss, m = eval_step(images, pngs, sm)
            for k, v in m.items():
                mc_sums[k] = mc_sums.get(k, 0.0) + float(v)
            c = None
        if c is not None:
            counts += c.cpu().numpy()
        total_loss += float(loss)
        seen += 1
    return split_metrics(task, total_loss, seen, counts, confusion, mc_sums)


def run_eval_resident(eval_chunk, data: resident.ResidentData, batch_size: int, seed: int,
                      max_batches: int | None, task: str) -> dict:
    """``split_metrics`` of the whole split resident on the card, read from it once.

    Counts are summed on the card; the per-batch losses (and multiclass's
    per-batch metrics) are summed on the host in batch order, as the host
    path sums them, so both paths give the same numbers.
    """
    idx, mask = resident.epoch_index_plan(data.n, batch_size, 0, False, seed, max_batches)
    outs = eval_chunk(data, *resident.upload_plan(idx, mask, data.images_u8.device))
    counts = np.zeros(4, np.int64)
    confusion = np.zeros((3, 3), np.int64)
    mc_sums: dict[str, float] = {}
    if task == "multitask":
        (loss, _, _), c, cf = outs
        loss, c, cf = read_once(loss, c.sum(0), cf.sum(0))
        counts, confusion = c.astype(np.int64), cf.astype(np.int64)
    elif task == "binary":
        loss, c = outs
        loss, c = read_once(loss, c.sum(0))
        counts = c.astype(np.int64)
    else:
        loss, m = outs
        loss, *values = read_once(loss, *m.values())
        for k, v in zip(m, values):
            mc_sums[k] = 0.0
            for x in v.tolist():
                mc_sums[k] += x
    total_loss = 0.0
    for x in loss.tolist():
        total_loss += x
    return split_metrics(task, total_loss, len(idx), counts, confusion, mc_sums)


def make_steps(args, model, optimizer, num_classes: int, pos_weight: float | None,
               group: mesh_lib.Group = None):
    """(train_step, eval_step) for ``args.task``, as the JAX CLI picks them."""
    if args.task == "binary":
        return (steps.make_binary_train_step(model, optimizer, args.loss, pos_weight,
                                             amp=args.amp, group=group),
                steps.make_binary_eval_step(model, args.loss, pos_weight, amp=args.amp,
                                            group=group))
    if args.task == "multitask":
        kw = {"seg_loss_name": args.loss, "cls_loss_weight": args.cls_loss_weight,
              "pos_weight": pos_weight, "amp": args.amp, "group": group}
        return (steps.make_multitask_train_step(model, optimizer, **kw),
                steps.make_multitask_eval_step(model, **kw))
    if args.loss in ("bce", "lovasz_hinge"):
        # The reference lowers these silently (its train.py keys only on
        # 'focal'); say so, so that loss tables cannot mislabel two CE runs.
        print(f"[WARN] --loss {args.loss} is binary-only; multiclass training "
              f"uses ce (+dice) instead")
    kw = {"focal": args.loss == "focal", "use_dice": args.use_dice, "amp": args.amp,
          "group": group}
    return (steps.make_multiclass_train_step(model, optimizer, num_classes, **kw),
            steps.make_multiclass_eval_step(model, num_classes, **kw))


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
    """Train as ``args`` say; returns the ``expN`` folder.

    A data axis above 1 outside a job starts its ranks here, one worker
    process each, and returns once they end.
    """
    check_supported(args)
    device = resolve_device(args.device)
    set_float32_precision()
    n_data = resolve_mesh_data(args, device)
    if n_data > 1 and not mesh_lib.in_job():
        return train_local_ranks(args, n_data, device)
    return train_rank(args, device, n_data)


def _rank_main(rank: int, args, results) -> None:
    set_float32_precision()  # a new process: the flags are its own
    exp_folder = train_rank(args, resolve_device(args.device), args.mesh_data)
    if rank == 0:
        results.put(exp_folder)


def train_local_ranks(args, n_data: int, device: torch.device) -> str:
    """``train`` on ``n_data`` local worker processes, one per rank; returns rank 0's ``expN``."""
    import torch.multiprocessing as mp

    args = copy.copy(args)
    args.mesh_data = n_data
    results = mp.get_context("spawn").SimpleQueue()
    mesh_lib.launch_local(_rank_main, n_data, (args, results),
                          backend=mesh_lib.backend_for(device))
    return results.get()


def train_rank(args, device: torch.device, n_data: int) -> str:
    """This process's rank of the run (the whole run for one process); returns ``expN``.

    Joins ``torchrun``'s job if there is one. Ranks other than 0 print nothing.
    """
    mesh_lib.init_multihost(backend=mesh_lib.backend_for(device))
    devices = None if device.type == "cuda" and device.index is None else [device] * n_data
    mesh = mesh_lib.make_mesh(n_data, args.mesh_space, devices)
    with contextlib.ExitStack() as stack:
        if not mesh.is_main:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        return _train(args, mesh.device if mesh.group is not None else device, mesh)


def _train(args, device: torch.device, mesh: mesh_lib.Mesh) -> str:
    main = mesh.is_main
    if args.amp is None:
        args.amp = resolve_amp_default(args.model, args.loss, args.task)
    generator = seed_everything(args.seed)
    num_classes = resolve_num_classes(args)
    train_epoch = args.epochs
    batch_size = args.batch_size

    exp_folder = mesh_lib.broadcast_object(mesh, create_exp_folder()[0] if main else None)
    weights_folder = os.path.join(exp_folder, "weights")
    os.makedirs(args.cache_dir, exist_ok=True)
    input_shape = [args.input_size, args.input_size]
    config_path = os.path.join(exp_folder, "config.json")
    if main:
        with open(config_path, "w", encoding="utf-8") as f:
            json.dump(vars(args), f, ensure_ascii=False, indent=2)

    print(f"Loading HF Dataset from: {args.data_path}, config: {args.data_config}")
    multitask = args.task == "multitask"
    # multitask: binary seg masks, with each sample's class label
    ds_task = "binary" if multitask else args.task

    def open_split(split):
        return open_source(args.data_path, args.data_config, split, args.cache_dir)

    def make_ds(split, augmentation):
        return SegmentationDataset(open_split(split), input_shape, num_classes,
                                   augmentation=augmentation, task=ds_task,
                                   return_cls_label=multitask, seed=args.seed)

    # The device-resident path is the default on the card, as the JAX CLI
    # takes it on an accelerator; on the CPU only when asked.
    use_device_aug = args.device_augment
    if use_device_aug is None:
        use_device_aug = device.type == "cuda"
    # The host-augmented train set: the host path's input, and on either path
    # the source of the auto pos_weight estimate (as the reference samples it).
    train_dataset = make_ds("train", True)
    if use_device_aug:
        print("[input] device-resident path: uint8 canvases uploaded to the card once, "
              "augmentation on the card, chunked epochs")
        train_cache = CanvasCache(open_split("train"), input_shape, return_cls_label=multitask)
        val_cache = CanvasCache(open_split("validation"), input_shape, return_cls_label=multitask)
        print(f"Train samples: {len(train_cache)}, Val samples: {len(val_cache)}")
    else:
        val_dataset = make_ds("validation", False)
        print(f"Train samples: {len(train_dataset)}, Val samples: {len(val_dataset)}")
        shard = {"rank": mesh.rank, "world_size": mesh.world_size}
        train_loader = DataLoader(train_dataset, batch_size, shuffle=True, seed=args.seed,
                                  prefetch=args.workers, **shard)
        val_loader = DataLoader(val_dataset, batch_size, shuffle=False, seed=args.seed,
                                prefetch=args.workers, **shard)

    # Binary training uses the diff head: the model emits the (N, H, W) logit
    # difference the binary loss and metrics consume; same parameters.
    # multitask_unet: a 1-channel seg head and a 3-way class head.
    model = build_model(args.model, num_classes, decoder_width=args.decoder_width,
                        diff_head=args.task == "binary", generator=generator, device=device)
    if args.weights:
        if os.path.exists(args.weights):
            checkpoint.restore_flexible(args.weights, model)
        else:
            print(f"[WARN] weights not found: {args.weights}; training from scratch")
    mesh_lib.replicate(mesh, model)

    init_lr_fit, min_lr_fit = schedules.resolve_init_lrs(batch_size, init_lr=args.lr)
    optimizer = schedules.make_train_optimizer(model.parameters(), init_lr_fit,
                                               momentum=args.momentum,
                                               weight_decay=args.weight_decay)
    lr_scheduler_func = schedules.get_lr_scheduler("cos", init_lr_fit, min_lr_fit, train_epoch)

    pos_weight = mesh_lib.broadcast_object(
        mesh, resolve_pos_weight(args, train_dataset) if main else None)
    if pos_weight is not None and main:
        # 'auto' is data-dependent: record the value val.py needs.
        with open(config_path, "w", encoding="utf-8") as f:
            json.dump({**vars(args), "resolved_pos_weight": pos_weight}, f,
                      ensure_ascii=False, indent=2)

    max_train_batches = args.max_train_batches or None
    max_val_batches = args.max_val_batches or None
    max_test_batches = args.max_test_batches or None
    train_step, eval_step = make_steps(args, model, optimizer, num_classes, pos_weight,
                                       group=mesh.group)

    if use_device_aug:
        train_res = resident.upload(train_cache, device)
        val_res = resident.upload(val_cache, device)
        binary = ds_task == "binary"
        train_chunk = resident.make_train_chunk_fn(train_step, tuple(input_shape), binary,
                                                   num_classes, multitask=multitask,
                                                   seed=args.seed, mesh=mesh)
        eval_chunk = resident.make_eval_chunk_fn(eval_step, binary, num_classes,
                                                 multitask=multitask, mesh=mesh)

    def evaluate(split_data, max_batches):
        if use_device_aug:
            return run_eval_resident(eval_chunk, split_data, batch_size, args.seed, max_batches,
                                     args.task)
        return run_eval(eval_step, split_data, max_batches, args.task)

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
            if os.path.exists(src) and main:
                shutil.copyfile(src, dst)
        print(f"[resume] restored {args.resume}: starting at epoch "
              f"{start_epoch + 1}/{train_epoch}, best={best_score:.4f}")

    def host_epoch(epoch: int):
        """(losses, multitask's (seg, cls, correct) or None, n_valid, rows) per step, host-fed."""
        for it, (images, pngs, cls, sm, n_valid) in enumerate(host_batches(train_loader, epoch)):
            if max_train_batches and it >= max_train_batches:
                break
            # The step's random draws (multitask's dropout) from (seed, epoch,
            # step), as the JAX CLI folds them in: --resume continues exactly.
            resident.seed_default_generator(
                device, resident.rank_seed(resident.step_seeds(args.seed, epoch, it)[0], mesh))
            if multitask:
                (total_l, seg_l, cls_l), correct = train_step(images, pngs, cls, sm)
                yield ([float(total_l)], [(float(seg_l), float(cls_l), int(correct))], [n_valid],
                       len(train_loader))
            else:
                yield [float(train_step(images, pngs, sm))], None, [n_valid], len(train_loader)

    def resident_epoch(epoch: int):
        """The same per chunk of ``--scan-chunk`` steps, read from the card once per chunk."""
        idx, maskp = resident.epoch_index_plan(train_res.n, batch_size, epoch, True, args.seed,
                                               max_train_batches)
        idx_t, mask_t = resident.upload_plan(idx, maskp, device)
        n_batches, chunk = len(idx), max(args.scan_chunk, 1)
        for c0 in range(0, n_batches, chunk):
            c1 = min(c0 + chunk, n_batches)
            out = train_chunk(train_res, idx_t[c0:c1], mask_t[c0:c1], epoch, range(c0, c1))
            n_valid = [int(v) for v in maskp[c0:c1].sum(1)]
            if multitask:
                total_l, seg_l, cls_l, correct = read_once(torch.stack(out))[0]
                yield (total_l.tolist(), list(zip(seg_l.tolist(), cls_l.tolist(),
                                                  correct.astype(int).tolist())),
                       n_valid, n_batches)
            else:
                yield read_once(out)[0].tolist(), None, n_valid, n_batches

    for epoch in range(start_epoch, train_epoch):
        lr_now = lr_scheduler_func(epoch)
        schedules.set_learning_rate(optimizer, lr_now)
        print_train_header()
        epoch_loss, seen, images_done = 0.0, 0, 0
        mt = {"seg": 0.0, "cls": 0.0, "correct": 0, "total": 0}
        t_epoch = time.time()
        for losses, mt_steps, n_valids, n_batches in (
                resident_epoch(epoch) if use_device_aug else host_epoch(epoch)):
            ips_images = images_done + sum(n_valids)
            ips = ips_images / max(time.time() - t_epoch, 1e-6)
            for j, loss_val in enumerate(losses):
                if mt_steps is not None:
                    seg_l, cls_l, correct = mt_steps[j]
                    mt["seg"] += seg_l
                    mt["cls"] += cls_l
                    mt["correct"] += correct
                    mt["total"] += n_valids[j]
                print_train_row(epoch, train_epoch, seen, n_batches, loss_val, lr_now,
                                args.input_size, ips)
                step += 1
                epoch_loss += loss_val
                seen += 1
            images_done = ips_images
        print(LogColor.RESET)
        avg = epoch_loss / max(seen, 1)
        train_losses.append(avg)
        if multitask:
            acc = 100.0 * mt["correct"] / max(mt["total"], 1)
            print(f"Epoch {epoch + 1}/{train_epoch} - Loss: {avg:.4f} "
                  f"(Seg: {mt['seg'] / max(seen, 1):.4f}, "
                  f"Cls: {mt['cls'] / max(seen, 1):.4f}), Cls Acc: {acc:.2f}%")

        metrics = evaluate(val_res if use_device_aug else val_loader, max_val_batches)
        if args.task == "multiclass":
            current_score = float(metrics["Mean IoU"])
        else:
            current_score = float(metrics["IoU"])
        if multitask:
            print(f"Val - IoU: {metrics['IoU']:.4f}, Dice: {metrics['Dice']:.4f}, "
                  f"Cls Acc: {metrics['Cls Acc']:.2f}%")
        val_losses.append(metrics["Loss"])
        val_metrics_history.append(metrics)
        if current_score > best_score:
            best_score, best_epoch, best_val_metrics = current_score, epoch + 1, metrics
            if args.defer_ckpt:
                deferred_best = {k: v.detach().clone() for k, v in model.state_dict().items()}
            elif main:
                checkpoint.save_weights(best_model_path, model)
            print(f"New best model saved with score: {best_score:.4f}")
        if not args.defer_ckpt and main:
            checkpoint.save_weights(last_model_path, model)
        if args.ckpt_every and (epoch + 1) % args.ckpt_every == 0 and main:
            checkpoint.save_state(
                os.path.join(weights_folder, "resume.pth"), model, optimizer, step,
                extra={
                    "epoch": epoch + 1, "seed": args.seed, "best_score": best_score,
                    "best_epoch": best_epoch, "best_val_metrics": best_val_metrics,
                    "train_losses": train_losses, "val_losses": val_losses,
                    "val_metrics_history": val_metrics_history,
                },
            )

    if args.defer_ckpt and main:
        if deferred_best is not None:
            checkpoint.save_weights(best_model_path, deferred_best)
        checkpoint.save_weights(last_model_path, model)
    mesh_lib.barrier(mesh)  # the test evaluation loads rank 0's best.pth

    total_time = time.time() - start_time
    print(f"Training completed in {datetime.timedelta(seconds=int(total_time))}")

    if main:
        try:
            plot_training_curves(train_losses, val_losses, val_metrics_history, weights_folder)
        except ImportError as e:  # no matplotlib: the run's other files still get written
            print(f"[WARN] training curves not written: {e}")

    test_metrics = None
    try:  # keep artifact writing alive, like the reference
        test_source = open_split("test")
        if use_device_aug:
            test_data = resident.upload(
                CanvasCache(test_source, input_shape, return_cls_label=multitask), device)
        else:
            test_data = DataLoader(make_ds("test", False), batch_size, shuffle=False,
                                   seed=args.seed, prefetch=2, rank=mesh.rank,
                                   world_size=mesh.world_size)
        checkpoint.load_weights(best_model_path, model)
        test_metrics = evaluate(test_data, max_test_batches)
        if main:
            with open(os.path.join(exp_folder, "test_metrics.json"), "w", encoding="utf-8") as f:
                json.dump(test_metrics, f, ensure_ascii=False, indent=2)

        if args.task in ("binary", "multitask") and args.export_vis and main:
            # binary: the diff head's sign, as the eval step predicts
            export_binary_visuals(steps.make_predict_fn(model, amp=args.amp), test_source,
                                  out_dir=os.path.join(exp_folder, "vis"),
                                  input_shape=tuple(input_shape), num_samples=args.vis_num,
                                  seed=args.vis_seed, multitask=multitask)
    except Exception as e:  # noqa: BLE001 - reported with its traceback, run goes on
        traceback.print_exc()
        print(f"[WARN] Skip test evaluation: {e}")

    if not main:
        return exp_folder
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
                        help="Segmentation task")
    parser.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS),
                        help="Model architecture (use 'multitask_unet' for multitask)")
    parser.add_argument("--decoder-width", default=1.0, type=float,
                        help="unet_resnet50 only: decoder width multiplier (1.0 = reference "
                             "decoder; checkpoints are width-specific)")
    parser.add_argument("--cls-loss-weight", default=1.0, type=float,
                        help="For multitask only: classification loss weight")
    parser.add_argument("--loss", default="lovasz_hinge",
                        choices=["bce", "lovasz_hinge", "ce", "focal"], help="Loss function")
    parser.add_argument("--pos-weight", default=None,
                        help="'auto', a float, or '' to disable: the seg BCE's positive-term "
                             "weight. Default: auto for binary BCE, OFF for multitask (the "
                             "reference never weights its multitask seg BCE)")
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
    parser.add_argument("--export-vis", action=boolopt, default=True,
                        help="Write vis/ prediction grids of the test split (binary, "
                             "multitask) after training")
    parser.add_argument("--vis-num", default=8, type=int)
    parser.add_argument("--vis-seed", default=0, type=int)
    parser.add_argument("--max-train-batches", default=0, type=int)
    parser.add_argument("--max-val-batches", default=0, type=int)
    parser.add_argument("--max-test-batches", default=0, type=int)
    parser.add_argument("--device-augment", action=boolopt, default=None,
                        help="Canvases resident on the device + augmentation there, in "
                             "chunked epochs (default: on for cuda, off for cpu)")
    parser.add_argument("--scan-chunk", default=8, type=int,
                        help="Train steps per host read on the device-resident path: a "
                             "chunk is a loop of steps whose losses stay on the device "
                             "until its end (there is no scan)")
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
                        help="Data-parallel axis size: ranks, one card (cpu: one process) "
                             "each (default: every visible card on cuda, 1 on cpu; under "
                             "torchrun, its processes)")
    parser.add_argument("--mesh-space", default=1, type=int,
                        help="Spatial-parallel axis size over image H: not ported, 1 only")
    args = parser.parse_args(argv)
    if args.pos_weight == "":
        args.pos_weight = None
    return args


if __name__ == "__main__":
    try:
        train(parse_args())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
