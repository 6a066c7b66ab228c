#!/usr/bin/env python3
"""Where the PyTorch port's predict time goes, on one CUDA card.

    python scripts/torch_profile_predict.py [--model unet_resnet50] [--batch 8]

Builds a full-width model (``--model``: unet_resnet50, unet_plain,
attention_unet or dualdense_unet; 2 classes, seeded random weights), then for
seeded letterboxed 480^2 canvases measures:

- ``predict_ms``: host clock per call of the port's batch-predict function
  (``predict.predict_probs``: host-to-card copy, bf16 forward, softmax,
  card-to-host copy), median and spread over 10 calls;
- ``forward_ms``: CUDA-event time of the forward alone on a tensor already
  on the card, called eagerly back to back (the host's dispatch included);
- ``forward_graph_ms``: the same forward captured once into a CUDA graph
  and replayed: the card's own time, without the host. Where
  ``forward_ms`` is the larger, the host holds the card back;
- a ``torch.profiler`` window over 10 predict calls: card time by
  kernel group, and the card's idle share of the window.

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

from unet_embroidery_seg_torch.data.synthetic import letterboxed_canvases  # noqa: E402
from unet_embroidery_seg_torch.engine.steps import make_predict_fn  # noqa: E402
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model  # noqa: E402
from unet_embroidery_seg_torch.predict import predict_probs  # noqa: E402
from unet_embroidery_seg_torch.utils.timing import device_ms_by_group, graph_ms  # noqa: E402

SIZE = 480  # the predict letterbox (predict.py --input-size default)
ITERS = 10  # calls per measurement

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="unet_resnet50",
                        choices=[m for m in SUPPORTED_MODELS if m != "multitask_unet"])
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args(argv)

    model = build_model(args.model, 2, generator=torch.Generator().manual_seed(0))
    predict_fn = make_predict_fn(model, amp=True)
    canvases = letterboxed_canvases(args.batch, SIZE, seed=0)
    for _ in range(3):
        predict_probs(predict_fn, canvases)

    predict_ms = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        predict_probs(predict_fn, canvases)
        predict_ms.append((time.perf_counter() - t0) * 1e3)

    x = torch.from_numpy(canvases).cuda()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    predict_fn(x)
    start.record()
    for _ in range(ITERS):
        predict_fn(x)
    end.record()
    end.synchronize()
    forward_ms = start.elapsed_time(end) / ITERS

    forward_graph_ms = graph_ms(lambda: predict_fn(x), forward_ms)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            predict_probs(predict_fn, canvases)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_group, top = device_ms_by_group(prof, ITERS)
    busy_ms = sum(by_group.values())
    per_call_window = window_ms / ITERS
    result = {
        "card": torch.cuda.get_device_name(0), "model": args.model,
        "batch": args.batch, "size": SIZE, "iters": ITERS,
        "predict_ms_median": statistics.median(predict_ms),
        "predict_ms_min": min(predict_ms), "predict_ms_max": max(predict_ms),
        "forward_ms": forward_ms,
        "forward_graph_ms": forward_graph_ms,
        "profiled_ms_per_call": per_call_window,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": (1.0 - busy_ms / per_call_window) if per_call_window else None,
        "device_ms_by_group": by_group,
        "top_kernels": top,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
