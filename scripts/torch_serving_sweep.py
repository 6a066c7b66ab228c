#!/usr/bin/env python3
"""Serving sweep of the port's ``torch.export`` artifact: predict throughput over size x batch.

    python scripts/torch_serving_sweep.py [--sizes 256 480 512] \
        [--batches 1 2 4 8 16 32] [--model unet_resnet50] [--weights best.pth] \
        [--no-amp] [--out TORCH_SERVING.json]

The counterpart of ``scripts/serving_sweep.py`` on one CUDA card. For each
(size, batch) point it exports the model's serving forward (what
``predict_probs`` computes: NHWC float32 in, softmax probabilities out;
bf16 unless ``--no-amp``) through ``export_serving.export_one`` on the card,
loads the artifact back through ``load_artifact`` and runs it on a seeded
input already on the card:

- ``images_per_sec``: batch x calls over the host clock around the calls,
  ended by a synchronise;
- ``device_ms_per_image``: CUDA events around the same run of calls, over
  calls x batch (the card's span, host gaps included where the host is
  slower than the card);
- ``ms_per_call``: the same span per call, and ``artifact_bytes``.

The weights are seeded random ones unless ``--weights`` names a ``.pth``.
The JSON is written after every point, with the card's name and power limit
(``nvidia-smi``) in it; a point already in the file is kept, not measured
again. Prints a markdown table at the end. Needs a card: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from unet_embroidery_seg_torch.engine import checkpoint  # noqa: E402
from unet_embroidery_seg_torch.export_serving import (  # noqa: E402
    build_predict,
    export_one,
    load_artifact,
)
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model  # noqa: E402
from unet_embroidery_seg_torch.utils.device import card_line, set_float32_precision  # noqa: E402,E501

WARMUP = 3
BUDGET_MS = 500.0  # measured calls per point: about this much card time, 5 to 50 calls


def measure(module, x: torch.Tensor) -> dict:
    """Time ``module(x)`` on the card: img/s by the host clock, card ms by CUDA events."""
    batch = x.shape[0]
    with torch.no_grad():
        for _ in range(WARMUP):
            module(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module(x)
        torch.cuda.synchronize()
        calls = int(max(5, min(50, BUDGET_MS / max((time.perf_counter() - t0) * 1e3, 1e-3))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            probs = module(x)
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if not torch.isfinite(probs).all():
        raise RuntimeError("the artifact returned non-finite probabilities")
    span_ms = start.elapsed_time(end)
    return {"calls": calls, "images_per_sec": batch * calls / wall_s,
            "device_ms_per_image": span_ms / (calls * batch), "ms_per_call": span_ms / calls}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[256, 480, 512])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8, 16, 32])
    p.add_argument("--model", default="unet_resnet50",
                   choices=[m for m in SUPPORTED_MODELS if m != "multitask_unet"])
    p.add_argument("--weights", default="", help="A model-only .pth; default: seeded weights")
    p.add_argument("--amp", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--out", default="TORCH_SERVING.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serving_sweep: no CUDA device available", file=sys.stderr)
        return 1
    set_float32_precision()

    results: dict = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    card = card_line()
    results.update({"card": card, "model": args.model, "amp": args.amp,
                    "weights": args.weights or "seeded (torch.Generator seed 0)",
                    "torch_version": torch.__version__})
    points = results.setdefault("points", {})

    model = build_model(args.model, 2, generator=torch.Generator().manual_seed(0))
    if args.weights:
        checkpoint.load_weights(args.weights, model)
    predict = build_predict(model, args.amp)
    for size in args.sizes:
        row = points.setdefault(str(size), {})
        for batch in args.batches:
            if str(batch) in row:
                print(f"[skip] {size}^2 b{batch}", file=sys.stderr, flush=True)
                continue
            print(f"[serving] {size}^2 b{batch}", file=sys.stderr, flush=True)
            data = export_one(predict, batch, size)
            x = torch.from_numpy(np.random.RandomState(0).rand(batch, size, size, 3)
                                 .astype(np.float32)).cuda()
            row[str(batch)] = {**measure(load_artifact(data), x), "artifact_bytes": len(data),
                               "card": card}
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
            torch.cuda.empty_cache()

    sizes = sorted(int(s) for s in points)
    batches = sorted({int(b) for row in points.values() for b in row})
    print(f"{card}; {args.model}, {'bf16' if args.amp else 'f32'}")
    print("| batch | " + " | ".join(f"{s}² img/s | {s}² ms/img" for s in sizes) + " |")
    print("|" + "---|" * (1 + 2 * len(sizes)))
    for b in batches:
        cells = []
        for s in sizes:
            pt = points.get(str(s), {}).get(str(b))
            cells += ([f"{pt['images_per_sec']:.1f}", f"{pt['device_ms_per_image']:.3f}"]
                      if pt else ["—", "—"])
        print(f"| {b} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
