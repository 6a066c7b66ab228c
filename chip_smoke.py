#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which raises on failure (the script exits 0 only if all pass):

1. Print the card's name and power limit; build the three CUDA kernel
   libraries from ``unet_embroidery_seg_torch/csrc`` (one nvcc each, in
   parallel).
2. Forward sites: at each of the 11 kernel sites of unet_resnet50 at 480^2,
   batch 8, bf16 (5 upsample, 6 square conv3x3), plus one f32 case per
   kernel: hold the kernel against its plain PyTorch version and time
   kernel, plain version and the library call that computes the same
   function (``F.interpolate``, ``F.conv2d``; the port never calls either)
   with CUDA events, grad off as in predict. ``ms`` and ``library_ms`` are
   the card's own time, by CUDA-graph replay (``ms_method``); ``eager_ms``
   and ``library_eager_ms`` are the same calls back to back from the host,
   dispatch included; ``plain_ms`` is eager. Each row names the kernel path
   taken (conv: ``c64_persistent``, ``wgmma`` or ``fma``) and its TFLOP/s
   and share of the bound, both from ``ms``. Then an in-place weight update
   between two conv calls on signed inputs must change the result (the
   wrapper's packed-weight cache repacks).
3. Backward sites, at the train shapes (512^2, batch 8, bf16) plus one f32
   case per kernel: upsample2x's backward at its 5 sites (the four decoder
   ones read their gradient as a channel slice of ``torch.cat``'s, in
   place) and conv3x3's dgrad at its 6, each against its plain version and
   timed like phase 2 (dgrad's time includes packing the flipped weights).
   Library yardsticks: ``aten.upsample_bilinear2d_backward`` and
   ``torch.nn.grad.conv2d_input``. Then, at one site of each kernel, the
   autograd Function's gradients against the plain version's autograd.
4. The predict path: full-width unet_resnet50 (2 classes, seeded random
   weights) predicting 16 seeded letterboxed 480^2 canvases in batches of
   8, bf16, through the port's batch-predict function. Launch counters are
   zeroed just before and read just after: 5 upsample and 6 conv3x3
   launches per forward. The softmax must be finite and sum to 1.
5. The train path: full-width unet_resnet50, binary, diff head, 512^2,
   batch 8, bf16 autocast, Lovasz hinge (the train CLI's default), Adam
   over float32 masters (lr 1e-4, the CLI's), 60 steps on one seeded batch
   through the port's train step. Counters zeroed just before, read just after: 5 upsample2x,
   5 upsample2x backward, 6 conv3x3 and 6 conv3x3 dgrad launches per step.
   Every parameter has a finite gradient that is nonzero somewhere; the
   loss falls; one eval step's counts sum to 8 * 512^2; an eval forward
   after one more step (packed-weight cache) equals a fresh model's.
6. f32 on the card against the CPU (TF32 off for matmul and cuDNN): one
   predict image at 480^2, logits and softmax; one train step at 128^2,
   batch 2, loss and every gradient, within a multiple of the noise floor
   of the CPU against itself with its input moved by an ulp.
7. Print the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX, PIL or cv2. Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
BATCH, SIZE = 8, 480
TRAIN_SIZE, TRAIN_STEPS = 512, 60
UPSAMPLE_SITES = [(2048, 15), (512, 30), (256, 60), (128, 120), (64, 240)]  # (C, H_in)
# Backward sites at 512^2: (name, C, H_in of the upsample / H of the conv,
# skip channels concatenated before the upsample's output, or 0).
UPSAMPLE_BWD_SITES = [("up_concat4.up", 2048, 16, 1024), ("up_concat3.up", 512, 32, 512),
                      ("up_concat2.up", 256, 64, 256), ("up_concat1.up", 128, 128, 64),
                      ("up_conv.0", 64, 256, 0)]
DGRAD_SITES = [("up_concat4.conv2", 512, 32), ("up_concat3.conv2", 256, 64),
               ("up_concat2.conv2", 128, 128), ("up_concat1.conv2", 64, 256),
               ("up_conv.1", 64, 512), ("up_conv.3", 64, 512)]
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
TOL_F32 = {"upsample2x": 1e-5, "conv3x3_same": 1e-4, "upsample2x_backward": 1e-5,
           "conv3x3_dgrad": 1e-4}
# The autograd Functions on the card (bf16): dW and db sum over every pixel
# (cuDNN's wgrad against f32 sums of the plain version), and the ReLU mask
# can differ where y rounds differently: 2% of each gradient's largest value.
TOL_FUNCTION = 2e-2
# Phase 6, train step: f32 both sides (cuDNN's convs against oneDNN's), but
# train-mode BN at batch 2 makes this model's gradients ill-conditioned: its
# backward subtracts the per-channel mean of the incoming gradient, nearly
# all of it, and so magnifies f32 rounding from block to block. A one-ulp
# change of the input moves the encoder's gradients by a few percent on the
# CPU alone. The card's run differs from the CPU's in every op's rounding,
# not only at the input, so it lands further away than that floor (about
# 2x, measured), and the floor may differ from CPU to CPU. So each gradient
# is held, as a share of its norm, to 4x the floor measured in the same run,
# plus 1e-4 for f32 rounding; the kernel sites' (up_concat*.conv2,
# up_conv.*) gradients to 1e-2; the loss to 1e-4.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD_SITES = 1e-4, 1e-2
TOL_TRAIN_NOISE_FACTOR, TOL_F32_GRAD = 4.0, 1e-4
TRAIN_LR = 1e-4  # phase 5: the train CLI's learning rate at batch 8
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


def measure_site(prefix: str, kernel: str, site: str, path: str, dtype, run, plain, library,
                 nbytes: float, flops: float, shapes: dict) -> dict:
    """Hold ``run`` against ``plain`` and time it, ``plain`` and ``library``: one site row.

    Prints the row after ``prefix``, then raises if the error is over the
    tolerance.
    """
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    got = run()
    torch.cuda.synchronize()
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    tol = (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32[kernel]) * want.float().abs().max().item()
    del got, want
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    eager_ms, library_eager_ms = event_ms(run), event_ms(library)
    ms = graph_ms(run, eager_ms)
    row = {
        "kernel": kernel, "site": site, "path": path, **shapes, "dtype": str(dtype),
        "max_abs_err": err, "tol": tol,
        "ms_method": MS_METHOD, "ms": ms, "eager_ms": eager_ms, "plain_ms": event_ms(plain),
        "library_ms": graph_ms(library, library_eager_ms), "library_eager_ms": library_eager_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
        "tflops": flops / ms / 1e9,
    }
    print(f"{prefix} " + json.dumps(row), flush=True)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{kernel} at {site}: max abs err {err} > tol {tol}")
    return row


@torch.no_grad()
def check_sites(gen: torch.Generator) -> list[dict]:
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_bias_relu,
        conv3x3_bias_relu_plain,
        conv3x3_path,
    )
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

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
        rows.append(measure_site("site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops, {"shape": list(x.shape)}))
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


def check_backward_sites(gen: torch.Generator) -> list[dict]:
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_dgrad_plain,
        conv3x3_path,
    )
    from unet_embroidery_seg_torch.ops.upsample import (
        upsample2x_backward,
        upsample2x_backward_plain,
    )

    dev = torch.device("cuda")
    cl = torch.channels_last
    cases = [("upsample2x_backward", n, c, h, skip, torch.bfloat16)
             for n, c, h, skip in UPSAMPLE_BWD_SITES]
    cases.append(("upsample2x_backward", "up_conv.0.f32", 64, 256, 0, torch.float32))
    cases += [("conv3x3_dgrad", n, c, h, 0, torch.bfloat16) for n, c, h in DGRAD_SITES]
    cases.append(("conv3x3_dgrad", "up_concat2.conv2.f32", 128, 128, 0, torch.float32))
    rows = []
    for kernel, site, c, h, skip, dtype in cases:
        if kernel == "upsample2x_backward":
            # The decoder's gradient: channels [skip:] of the cat's gradient.
            full = torch.randn(BATCH, skip + c, 2 * h, 2 * h, generator=gen)
            g = full.to(dev, dtype).contiguous(memory_format=cl)[:, skip:]
            es = g.element_size()
            run = lambda: upsample2x_backward(g, True)  # noqa: E731
            plain = lambda: upsample2x_backward_plain(g, True)  # noqa: E731
            library = lambda: torch.ops.aten.upsample_bilinear2d_backward(  # noqa: E731
                g, [2 * h, 2 * h], [BATCH, c, h, h], True)
            nbytes = g.numel() * es * 5 / 4  # read g once, write dx (a quarter of it)
            flops = 8.0 * g.numel()  # each g element feeds <= 4 dx elements, one FMA each
            path = "staged, cat slice" if skip else "staged"
        else:
            g = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype).contiguous(memory_format=cl)
            es = g.element_size()
            w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
            # channels_last, as the model's convs hold their weights, so the
            # yardstick gets the layouts the model's own backward gives cuDNN
            wd = w.to(dtype).contiguous(memory_format=cl)
            run = lambda: conv3x3_dgrad(g, w)  # noqa: E731
            plain = lambda: conv3x3_dgrad_plain(g, w)  # noqa: E731
            library = lambda: torch.nn.grad.conv2d_input(g.shape, wd, g, padding=1)  # noqa: E731
            nbytes = 2 * g.numel() * es + 9 * c * c * es
            flops = 2.0 * 9 * c * c * BATCH * h * h
            path = conv3x3_path(c, dtype)
        rows.append(measure_site("backward_site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape)}))
    return rows


def function_check(gen: torch.Generator) -> dict:
    """The autograd Functions' gradients on the card against the plain versions' autograd.

    conv3x3 at up_concat2.conv2 (128 channels, 128^2) and upsample2x at
    up_concat2.up (256 channels, 64^2 -> 128^2, its output concatenated
    after a skip as in the decoder), batch 8, bf16 activations, float32
    parameters.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_bias_relu_plain
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

    dev, cl = torch.device("cuda"), torch.channels_last
    x = torch.relu(torch.randn(BATCH, 128, 128, 128, generator=gen)).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=cl).requires_grad_()
    w = (torch.randn(128, 128, 3, 3, generator=gen) / (3 * 128 ** 0.5)).to(dev).requires_grad_()
    b = (0.1 * torch.randn(128, generator=gen)).to(dev).requires_grad_()
    g = torch.randn(BATCH, 128, 128, 128, generator=gen).to(dev, torch.bfloat16)
    got = torch.autograd.grad(conv3x3_bias_relu(x, w, b), (x, w, b), g)
    want = torch.autograd.grad(conv3x3_bias_relu_plain(x, w, b), (x, w, b), g)
    result = {}
    for name, a, r in zip(("conv_dx", "conv_dW", "conv_db"), got, want):
        result[name] = {"max_abs_err": (a.float() - r.float()).abs().max().item(),
                        "tol": TOL_FUNCTION * r.float().abs().max().item()}
    u = torch.randn(BATCH, 256, 64, 64, generator=gen).to(dev, torch.bfloat16)
    u = u.contiguous(memory_format=cl).requires_grad_()
    skip = torch.randn(BATCH, 256, 128, 128, generator=gen).to(dev, torch.bfloat16)
    skip = skip.contiguous(memory_format=cl)
    gu = torch.randn(BATCH, 512, 128, 128, generator=gen).to(dev, torch.bfloat16)
    gu = gu.contiguous(memory_format=cl)
    (du,) = torch.autograd.grad(torch.cat([skip, upsample2x(u, True)], 1), u, gu)
    (du_ref,) = torch.autograd.grad(torch.cat([skip, upsample2x_plain(u, True)], 1), u, gu)
    result["upsample_dx"] = {"max_abs_err": (du.float() - du_ref.float()).abs().max().item(),
                             "tol": TOL_BF16 * du_ref.float().abs().max().item()}
    print("function_check " + json.dumps(result), flush=True)
    for name, r in result.items():
        if not (np.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= r["tol"]):
            raise AssertionError(f"autograd Function {name}: {r}")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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


def train_path(counters) -> dict:
    """TRAIN_STEPS bf16 train steps of full-width unet_resnet50 at 512^2, batch 8, on one batch."""
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.engine.steps import make_binary_eval_step, make_binary_train_step
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules

    model = build_model("unet_resnet50", 2, diff_head=True,
                        generator=torch.Generator().manual_seed(0))
    opt = schedules.make_train_optimizer(model.parameters(), TRAIN_LR)
    step = make_binary_train_step(model, opt, "lovasz_hinge")
    batch = seeded_train_batch(BATCH, TRAIN_SIZE, seed=0)
    losses = [float(step(*batch))]  # warm-up: cuDNN plans, kernel loads, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for c in counters:
        c.launches = 0
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))  # float() waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = {"upsample2x": 5 * TRAIN_STEPS, "upsample2x_backward": 5 * TRAIN_STEPS,
            "conv3x3_bias_relu": 6 * TRAIN_STEPS, "conv3x3_dgrad": 6 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train launches {launches} != expected {want}")
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    if no_grad:
        raise AssertionError(f"{len(no_grad)} parameters without a finite nonzero gradient: "
                             f"{no_grad[:5]}")
    # Lovasz at this init sits near 1.0 for ~40 steps, then falls with
    # single-step spikes: the mean of the last ten against the first ten.
    if not (np.isfinite(losses).all() and np.mean(losses[-10:]) < np.mean(losses[:10])):
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")

    _, counts = make_binary_eval_step(model, "lovasz_hinge")(*batch)
    if int(counts.sum()) != BATCH * TRAIN_SIZE ** 2:
        raise AssertionError(f"eval counts {counts.tolist()} do not sum to {BATCH * TRAIN_SIZE ** 2}")

    # An eval forward (grad off: packed weights from the cache) after one
    # more step must see the step: equal to a fresh model with the weights.
    x = torch.from_numpy(batch[0]).cuda().permute(0, 3, 1, 2)

    def forward(m):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return m.eval()(x).float()

    before = forward(model)
    step(*batch)
    after = forward(model)
    fresh = build_model("unet_resnet50", 2, diff_head=True)
    fresh.load_state_dict(model.state_dict(), strict=True)
    changed = (after - before).abs().max().item()
    stale = (after - forward(fresh)).abs().max().item()
    if not (changed > 0 and stale <= 0.1 * changed):
        raise AssertionError(f"eval after a step: changed by {changed}, off a fresh model by {stale}")

    result = {
        "steps": TRAIN_STEPS, "size": TRAIN_SIZE, "batch": BATCH, "loss": "lovasz_hinge",
        "lr": TRAIN_LR,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms, "graph_replay_ms": None,
        "losses": losses, "launches": launches, "launches_per_step": {
            k: v / TRAIN_STEPS for k, v in launches.items()},
        "params_with_grad": sum(1 for _ in model.parameters()),
        "eval_counts": counts.tolist(), "eval_after_step": {"changed": changed, "off_fresh": stale},
        "peak_mem_gb": peak_gb,
    }
    print("train_path " + json.dumps(result), flush=True)
    return result


def f32_train_card_vs_cpu() -> dict:
    """One f32 train step (BCE, pos_weight 3) at 128^2, batch 2: card against CPU.

    Four runs from one state: the CPU, the CPU with every input pixel moved
    by about one f32 ulp up (x (1 + 2^-23)) and down (x (1 - 2^-23)), and
    the card. The larger of the two moves, per gradient, is this model's f32
    noise floor, which the card is held to.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules

    state = build_model("unet_resnet50", 2, diff_head=True, device="cpu",
                        generator=torch.Generator().manual_seed(3)).state_dict()
    images, pngs, sm = seeded_train_batch(2, 128, seed=3)
    runs = {"cpu": ("cpu", images), "cpu_up": ("cpu", images * np.float32(1 + 2.0 ** -23)),
            "cpu_down": ("cpu", images * np.float32(1 - 2.0 ** -23)), "card": ("cuda", images)}
    loss, grads = {}, {}
    for name, (dev, imgs) in runs.items():
        model = build_model("unet_resnet50", 2, diff_head=True, device=dev)
        model.load_state_dict(state, strict=True)
        opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
        loss[name] = float(make_binary_train_step(model, opt, "bce", 3.0, amp=False)(imgs, pngs, sm))
        grads[name] = {n: p.grad.cpu() for n, p in model.named_parameters()}

    def rel(run: str) -> dict:
        return {n: ((g - grads["cpu"][n]).norm() / grads["cpu"][n].norm().clamp_min(1e-30)).item()
                for n, g in grads[run].items()}

    card, up, down = rel("card"), rel("cpu_up"), rel("cpu_down")
    noise = {n: max(up[n], down[n]) for n in card}
    worst = max(card, key=card.get)
    sites = [n for n in card
             if n.startswith("up_conv.") or (n.startswith("up_concat") and ".conv2." in n)]
    result = {"loss_card": loss["card"], "loss_cpu": loss["cpu"],
              "loss_cpu_up": loss["cpu_up"], "loss_cpu_down": loss["cpu_down"],
              "loss_rel_diff": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
              "median_grad_rel_diff": statistics.median(card.values()),
              "median_grad_rel_noise": statistics.median(noise.values()),
              "worst_grad_rel_diff": card[worst], "worst_grad_param": worst,
              "worst_grad_rel_noise": max(noise.values()),
              "kernel_site_grad_rel_diff": {n: card[n] for n in sites}}
    print("f32_train_card_vs_cpu " + json.dumps(result), flush=True)
    floor = lambda v: TOL_TRAIN_NOISE_FACTOR * v + TOL_F32_GRAD  # noqa: E731
    if not (np.isfinite(list(card.values())).all()
            and result["loss_rel_diff"] <= TOL_TRAIN_LOSS
            and max(card[n] for n in sites) <= TOL_TRAIN_GRAD_SITES
            and result["median_grad_rel_diff"] <= floor(result["median_grad_rel_noise"])
            and card[worst] <= floor(result["worst_grad_rel_noise"])):
        raise AssertionError(f"f32 train step card vs CPU disagree: {result}")
    return result


def kernel_summary(rows: list[dict], launches: dict) -> list[dict]:
    """One entry per kernel: its bf16 sites summed (one forward, or one backward, runs them all)."""
    meta = {
        "upsample2x": ("unet_embroidery_seg_torch/csrc/upsample2x.cu",
                       "docs/negative-results/pallas_upsample.py:207", "upsample2x"),
        "upsample2x_backward": ("unet_embroidery_seg_torch/csrc/upsample2x_bwd.cu",
                                "docs/negative-results/pallas_upsample.py:207",
                                "upsample2x_backward"),
        "conv3x3_same": ("unet_embroidery_seg_torch/csrc/conv3x3_same.cu",
                         "docs/negative-results/pallas_conv.py:61", "conv3x3_bias_relu"),
        "conv3x3_dgrad": ("unet_embroidery_seg_torch/csrc/conv3x3_same.cu",
                          "docs/negative-results/pallas_conv.py:61", "conv3x3_dgrad"),
    }
    out = []
    for name, (source, replaces, counter) in meta.items():
        sites = [r for r in rows if r["kernel"] == name and r["dtype"] == "torch.bfloat16"]
        # One pass runs the sites one after another, so its bound is the sum
        # of theirs; bound_by names the limit behind most of that sum.
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
            "sites": "480^2 forward" if name in ("upsample2x", "conv3x3_same") else "512^2 backward",
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
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build(["upsample2x", "upsample2x_bwd", "conv3x3_same"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)

    rows = check_sites(torch.Generator().manual_seed(0))
    update = weight_update_check(torch.Generator().manual_seed(2))
    bwd_rows = check_backward_sites(torch.Generator().manual_seed(4))
    functions = function_check(torch.Generator().manual_seed(5))
    path = main_path([upsample2x, conv3x3_bias_relu])
    train = train_path([upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad])
    f32 = f32_card_vs_cpu()
    f32_train = f32_train_card_vs_cpu()
    kernels = kernel_summary(rows + bwd_rows, train["launches"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "sites": rows,
                       "weight_update": update, "backward_sites": bwd_rows,
                       "function_check": functions, "main_path": path, "train_path": train,
                       "f32_card_vs_cpu": f32, "f32_train_card_vs_cpu": f32_train,
                       "kernels": kernels, "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
