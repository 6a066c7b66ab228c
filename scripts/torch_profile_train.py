#!/usr/bin/env python3
"""Where the PyTorch port's binary train step goes, on one CUDA card.

    python scripts/torch_profile_train.py [--model unet_resnet50] [--batch 8] [--size 512]
        [--loss lovasz_hinge] [--no-amp]

Builds a full-width model (``--model``: unet_resnet50, unet_plain,
attention_unet or dualdense_unet) with the diff head (seeded random weights)
and the port's train step (bf16 autocast, Adam over float32 masters), then
on one seeded batch measures:

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

from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch  # noqa: E402
from unet_embroidery_seg_torch.engine.steps import make_binary_train_step  # noqa: E402
from unet_embroidery_seg_torch.models import build_model  # noqa: E402
from unet_embroidery_seg_torch.ops import schedules  # noqa: E402
from unet_embroidery_seg_torch.train import TRAINED_MODELS as PORTED  # noqa: E402
from unet_embroidery_seg_torch.utils.timing import device_ms_by_group  # noqa: E402

ITERS, PROFILED = 10, 5

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="unet_resnet50", choices=PORTED)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--loss", default="lovasz_hinge", choices=["bce", "lovasz_hinge"])
    parser.add_argument("--amp", action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 autocast (default); --no-amp trains in f32, cuDNN with "
                             "PyTorch's default TF32")
    args = parser.parse_args(argv)

    model = build_model(args.model, 2, diff_head=True,
                        generator=torch.Generator().manual_seed(0))
    opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
    step = make_binary_train_step(model, opt, args.loss, 3.0 if args.loss == "bce" else None,
                                  amp=args.amp)
    batch = seeded_train_batch(args.batch, args.size, seed=0)
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
        "card": torch.cuda.get_device_name(0), "model": args.model,
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
