#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which raises on failure (the script exits 0 only if all pass):

1. Print the card's name and power limit; build both CUDA kernels from
   ``unet_embroidery_seg_torch/csrc`` (one nvcc each, in parallel).
2. At each of the 11 kernel sites of unet_resnet50 at 480^2, batch 8, bf16
   (5 upsample, 6 square conv3x3), plus one f32 case per kernel: hold the
   kernel against its plain PyTorch version and time kernel, plain version
   and the library call that computes the same function (``F.interpolate``,
   ``F.conv2d``; the port never calls either) with CUDA events, grad off as
   in predict. ``ms`` and ``library_ms`` are the card's own time, by
   CUDA-graph replay (``ms_method``); ``eager_ms`` and ``library_eager_ms``
   are the same calls back to back from the host, dispatch included (the
   method behind ``ms`` before the kernels' Hopper redesign); ``plain_ms``
   is eager (the plain version builds its tables on the host). Each row
   names the kernel path taken (conv: ``c64_persistent``, ``wgmma`` or
   ``fma``) and its TFLOP/s and share of the bound, both from ``ms``.
   Then an in-place weight update between two conv calls on signed inputs
   must change the result (the wrapper's packed-weight cache repacks).
3. The main path: full-width unet_resnet50 (2 classes, seeded random
   weights) predicting 16 seeded letterboxed 480^2 canvases in batches of
   8, bf16, through the port's batch-predict function. The launch counters
   are zeroed just before and read just after: 5 upsample and 6 conv3x3
   launches per forward. The softmax must be finite and sum to 1.
4. One image in f32 on the card (TF32 off for matmul and cuDNN) and on the
   CPU (the kernels' plain versions); the logits and softmax must agree.
5. Print the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX, PIL or cv2. Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
BATCH, SIZE = 8, 480
UPSAMPLE_SITES = [(2048, 15), (512, 30), (256, 60), (128, 120), (64, 240)]  # (C, H_in)
CONV_SITES = [
    ("up_concat4.conv2", 512, 30), ("up_concat3.conv2", 256, 60),
    ("up_concat2.conv2", 128, 120), ("up_concat1.conv2", 64, 240),
    ("up_conv.1", 64, 480), ("up_conv.3", 64, 480),
]
# Tolerances, as a share of the largest reference value. bf16: kernel and
# plain version compute in f32 from the same bf16 inputs, so a result may
# round to the neighbouring bf16 value: one ulp, <= 2^-7 of the largest value.
# f32: summation order only (<= 4-term lerps; 9*128 conv terms).
TOL_BF16 = 2.0 ** -7
TOL_F32 = {"upsample2x": 1e-5, "conv3x3_same": 1e-4}
# Phase 4: f32 on both sides, ~70 layers summed in other orders by cuDNN and
# the CPU's convs: 1e-3 of the logit scale; softmax likewise to 1e-3.
TOL_FORWARD_REL, TOL_SOFTMAX = 1e-3, 1e-3
# How kernel and library ``ms`` are timed: calls captured into a CUDA graph
# and replayed, so the host's dispatch (as long as the smallest sites' card
# time) stays out; the eager time sits beside it as ``eager_ms``.
MS_METHOD = "cuda_graph_replay"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@torch.no_grad()
def check_sites(gen: torch.Generator) -> list[dict]:
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_bias_relu,
        conv3x3_bias_relu_plain,
        conv3x3_path,
    )
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    dev = torch.device("cuda")
    cases = [("upsample2x", f"up{c}x{h}", c, h, torch.bfloat16) for c, h in UPSAMPLE_SITES]
    cases.append(("upsample2x", "up64x240.f32", 64, 240, torch.float32))
    cases += [("conv3x3_same", n, c, h, torch.bfloat16) for n, c, h in CONV_SITES]
    cases.append(("conv3x3_same", "up_concat2.conv2.f32", 128, 120, torch.float32))
    rows = []
    for kernel, site, c, h, dtype in cases:
        x = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype)
        es = x.element_size()
        if kernel == "upsample2x":
            x = x.contiguous(memory_format=torch.channels_last)
            run = lambda: upsample2x(x, True)  # noqa: E731
            plain = lambda: upsample2x_plain(x, True)  # noqa: E731
            library = lambda: F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)  # noqa: E731
            nbytes = x.numel() * es * 5  # read x once, write 4x
            flops = 9.0 * 4 * x.numel()  # 3 lerps of 3 FLOP per output element
            path = "staged"
        else:
            # decoder convs read ReLU outputs
            x = torch.relu(x).contiguous(memory_format=torch.channels_last)
            w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
            b = (0.1 * torch.randn(c, generator=gen)).to(dev)
            wd, bd = w.to(dtype), b.to(dtype)
            run = lambda: conv3x3_bias_relu(x, w, b)  # noqa: E731
            plain = lambda: conv3x3_bias_relu_plain(x, w, b)  # noqa: E731
            library = lambda: F.conv2d(x, wd, bd, padding=1)  # noqa: E731
            nbytes = 2 * x.numel() * es + 9 * c * c * es + 4 * c
            flops = 2.0 * 9 * c * c * BATCH * h * h
            path = conv3x3_path(c, dtype)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32[kernel]) * scale
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        eager_ms, library_eager_ms = event_ms(run), event_ms(library)
        ms = graph_ms(run, eager_ms)
        row = {
            "kernel": kernel, "site": site, "path": path, "shape": list(x.shape),
            "dtype": str(dtype), "max_abs_err": err, "tol": tol,
            "ms_method": MS_METHOD, "ms": ms, "eager_ms": eager_ms, "plain_ms": event_ms(plain),
            "library_ms": graph_ms(library, library_eager_ms),
            "library_eager_ms": library_eager_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
            "tflops": flops / ms / 1e9,
        }
        print("site " + json.dumps(row), flush=True)
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"{kernel} at {site}: max abs err {err} > tol {tol}")
        rows.append(row)
        del x, got, want
    return rows


@torch.no_grad()
def weight_update_check(gen: torch.Generator) -> dict:
    """An in-place weight update between two kernel calls changes the result.

    With grad off the conv wrapper caches its packed weights per parameter
    version; this holds, at one site of each tensor-core path, that the
    second call sees the update (and matches the plain version after it).
    The inputs are signed, where the decoder sites above read ReLU outputs.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_bias_relu_plain

    dev = torch.device("cuda")
    result = {}
    for c, h in ((64, 240), (512, 30)):
        x = torch.randn(BATCH, c, h, h, generator=gen).to(dev, torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        first = conv3x3_bias_relu(x, w, b)
        w.mul_(-1.0)  # flips which outputs survive the ReLU
        second = conv3x3_bias_relu(x, w, b)
        want = conv3x3_bias_relu_plain(x, w, b)
        changed = (first.float() - second.float()).abs().max().item()
        err = (second.float() - want.float()).abs().max().item()
        tol = TOL_BF16 * want.float().abs().max().item()
        result[f"c{c}"] = {"changed_by": changed, "max_abs_err": err, "tol": tol}
        if not (changed > 0 and err <= tol):
            raise AssertionError(f"in-place weight update at C={c}: {result[f'c{c}']}")
    print("weight_update " + json.dumps(result), flush=True)
    return result


def main_path(counters) -> dict:
    from unet_embroidery_seg_torch.data.synthetic import letterboxed_canvases
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.predict import predict_probs

    model = build_model("unet_resnet50", 2, generator=torch.Generator().manual_seed(0))
    predict_fn = make_predict_fn(model, amp=True)
    canvases = letterboxed_canvases(2 * BATCH, SIZE, seed=0)
    predict_probs(predict_fn, canvases[:BATCH])  # warm-up: cuDNN plans, kernel loads

    for c in counters:
        c.launches = 0
    batch_ms, probs = [], []
    for start in range(0, len(canvases), BATCH):
        t0 = time.perf_counter()
        probs.append(predict_probs(predict_fn, canvases[start : start + BATCH]))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}

    forwards = len(batch_ms)
    want = {"upsample2x": 5 * forwards, "conv3x3_bias_relu": 6 * forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    p = np.concatenate(probs)
    if p.shape != (2 * BATCH, SIZE, SIZE, 2) or not np.isfinite(p).all():
        raise AssertionError(f"bad softmax: shape {p.shape}, finite {np.isfinite(p).all()}")
    sum_err = float(np.abs(p.sum(-1) - 1.0).max())
    if sum_err > 1e-5:  # f32 softmax of f32 logits
        raise AssertionError(f"softmax sums off by {sum_err}")
    result = {"batch_ms": batch_ms, "launches": launches, "softmax_sum_err": sum_err,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("main_path " + json.dumps(result), flush=True)
    return result


@torch.no_grad()
def f32_card_vs_cpu() -> dict:
    from unet_embroidery_seg_torch.data.synthetic import letterboxed_canvases
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn
    from unet_embroidery_seg_torch.models import build_model

    gen = torch.Generator().manual_seed(1)
    cpu_model = build_model("unet_resnet50", 2, generator=gen, device="cpu")
    # Fan-in scaled weights: the reference N(0, 0.02) init shrinks the logits
    # toward 1e-4, which would make the comparison say little.
    for m in cpu_model.modules():
        if isinstance(getattr(m, "weight", None), torch.Tensor) and m.weight.dim() == 4:
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
    card_model = build_model("unet_resnet50", 2)
    card_model.load_state_dict(cpu_model.state_dict(), strict=True)
    x = letterboxed_canvases(1, SIZE, seed=1)
    on_card = make_predict_fn(card_model, amp=False)(x).cpu()
    on_cpu = make_predict_fn(cpu_model, amp=False)(x)
    scale = on_cpu.abs().max().item()
    logit_err = (on_card - on_cpu).abs().max().item()
    softmax_err = (on_card.softmax(-1) - on_cpu.softmax(-1)).abs().max().item()
    result = {"logit_scale": scale, "max_logit_diff": logit_err,
              "max_softmax_diff": softmax_err}
    print("f32_card_vs_cpu " + json.dumps(result), flush=True)
    if not (logit_err <= TOL_FORWARD_REL * scale and softmax_err <= TOL_SOFTMAX):
        raise AssertionError(f"f32 card vs CPU disagree: {result}")
    return result


def kernel_summary(rows: list[dict], launches: dict) -> list[dict]:
    meta = {
        "upsample2x": ("unet_embroidery_seg_torch/csrc/upsample2x.cu",
                       "docs/negative-results/pallas_upsample.py:207", "upsample2x"),
        "conv3x3_same": ("unet_embroidery_seg_torch/csrc/conv3x3_same.cu",
                         "docs/negative-results/pallas_conv.py:61", "conv3x3_bias_relu"),
    }
    out = []
    for name, (source, replaces, counter) in meta.items():
        sites = [r for r in rows if r["kernel"] == name and r["dtype"] == "torch.bfloat16"]
        # One forward runs the sites one after another, so its bound is the
        # sum of theirs; bound_by names the limit behind most of that sum.
        share: dict[str, float] = {}
        for r in sites:
            share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["bound_ms"]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[counter],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            "ms_method": MS_METHOD,
            "ms": sum(r["ms"] for r in sites),
            "eager_ms": sum(r["eager_ms"] for r in sites),
            "plain_ms": sum(r["plain_ms"] for r in sites),
            "bound_ms": sum(share.values()),
            "bound_by": max(share, key=share.get),
            "library_ms": sum(r["library_ms"] for r in sites),
            "library_eager_ms": sum(r["library_eager_ms"] for r in sites),
        })
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the full report as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from unet_embroidery_seg_torch.ops import _build
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
    from unet_embroidery_seg_torch.ops.upsample import upsample2x

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build(["upsample2x", "conv3x3_same"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)

    rows = check_sites(torch.Generator().manual_seed(0))
    update = weight_update_check(torch.Generator().manual_seed(2))
    path = main_path([upsample2x, conv3x3_bias_relu])
    f32 = f32_card_vs_cpu()
    kernels = kernel_summary(rows, path["launches"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "sites": rows,
                       "weight_update": update, "main_path": path,
                       "f32_card_vs_cpu": f32, "kernels": kernels,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
