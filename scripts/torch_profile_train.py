#!/usr/bin/env python3
"""Where the PyTorch port's train step goes, on one CUDA card.

    python scripts/torch_profile_train.py [--task binary] [--model unet_resnet50] [--batch 8]
        [--size 512] [--loss lovasz_hinge] [--no-amp]

Builds a full-width model with seeded random weights and the port's train
step for ``--task`` (bf16 autocast, Adam over float32 masters):

- ``binary``: ``--model`` unet_resnet50, unet_plain, attention_unet or
  dualdense_unet with the diff head; ``--loss`` bce (pos_weight 3) or
  lovasz_hinge;
- ``multiclass``: the same models with 5 output classes, CE (``--loss
  ce``) or focal (``--loss focal``), plus Dice;
- ``multitask``: multitask_unet (``--model`` is ignored), seg BCE
  (unweighted, the task's default) or Lovasz, plus the class CE.

Then, on one seeded batch (``data/synthetic.seeded_task_batch``), it measures:

- ``step_ms``: host clock per train step ending in a synchronise (forward,
  loss, backward, Adam), median and spread over 10 steps after 3 warm-ups;
- a ``torch.profiler`` window over 5 steps: card time per step by kernel
  group, the card's idle share of the window, and the top kernels;
- ``peak_mem_gb``: the most memory the card held for a step.

Prints one JSON object as its last line. Needs a card; it does not fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from unet_embroidery_seg_torch.data.synthetic import seeded_task_batch  # noqa: E402
from unet_embroidery_seg_torch.engine import steps  # noqa: E402
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model  # noqa: E402
from unet_embroidery_seg_torch.ops import schedules  # noqa: E402
from unet_embroidery_seg_torch.utils.timing import device_ms_by_group  # noqa: E402

ITERS, PROFILED = 10, 5
NUM_CLASSES = 5  # multiclass: --num-classes 4, plus the background


def make_step(task: str, model_name: str, loss: str, amp: bool):
    """The train step of ``task`` over a full-width seeded model."""
    gen = torch.Generator().manual_seed(0)
    if task == "multitask":
        model = build_model("multitask_unet", 1, generator=gen)
        opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
        return steps.make_multitask_train_step(model, opt, loss, amp=amp)
    if task == "multiclass":
        model = build_model(model_name, NUM_CLASSES, generator=gen)
        opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
        return steps.make_multiclass_train_step(model, opt, NUM_CLASSES, focal=loss == "focal",
                                                amp=amp)
    model = build_model(model_name, 2, diff_head=True, generator=gen)
    opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
    return steps.make_binary_train_step(model, opt, loss, 3.0 if loss == "bce" else None,
                                        amp=amp)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", default="binary", choices=["binary", "multiclass", "multitask"])
    parser.add_argument("--model", default="unet_resnet50",
                        choices=[m for m in SUPPORTED_MODELS if m != "multitask_unet"])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--loss", default="lovasz_hinge",
                        choices=["bce", "lovasz_hinge", "ce", "focal"])
    parser.add_argument("--amp", action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 autocast (default); --no-amp trains in f32, cuDNN with "
                             "PyTorch's default TF32")
    args = parser.parse_args(argv)

    if args.task == "multitask":
        args.model = "multitask_unet"
    step = make_step(args.task, args.model, args.loss, args.amp)
    batch = seeded_task_batch(args.batch, args.size, seed=0, task=args.task,
                              num_classes=NUM_CLASSES)
    for _ in range(3):
        step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    step_ms = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step(*batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_group, top = device_ms_by_group(prof, PROFILED)
    busy_ms = sum(by_group.values())
    per_step_window = window_ms / PROFILED
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "task": args.task, "model": args.model,
        "batch": args.batch, "size": args.size, "loss": args.loss, "amp": args.amp,
        "iters": ITERS,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "images_per_s": args.batch / statistics.median(step_ms) * 1e3,
        "profiled_ms_per_step": per_step_window,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / per_step_window,
        "device_ms_by_group": by_group,
        "top_kernels": top,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
