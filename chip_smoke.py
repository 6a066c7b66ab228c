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

Phases 7-9 take the same kernels to their sites in unet_plain, attention_unet
and dualdense_unet (upsample in align_corners=False; the bias-free conv, its
epilogue off, at the conv2 of every DoubleConv):

7. Forward sites at 480^2, batch 8, bf16, as phase 2: the bias-free conv
   at its 5 distinct shapes (9 sites, C = 64 to 1024, signed inputs) and
   the upsample at its 4 sites, plus one f32 case of each (the conv at
   C = 1024 on ``fma``); yardsticks ``F.conv2d`` without bias and
   ``F.interpolate(align_corners=False)``. Backward sites at 512^2 as
   phase 3: the upsample backward at its 4 sites (channel slices of cat
   gradients after skips of 512, 256, 128 and 64), dgrad at the 5 shapes,
   plus one f32 case of each. The Functions' gradients against plain
   autograd: the bias-free conv's dx and dW; the upsample's dx where its
   output feeds both a concat and a 1x1 conv (attention_unet's gate), with
   the layout in which that summed gradient reaches the kernel. Then the
   card and host cost of packing the 9 sites' weights (forward and dgrad)
   in one train step.
8. For each family, full width, seeded weights: predict as phase 4 (4
   upsample and 9 bias-free conv launches per forward; dualdense_unet 4
   and 0; no fused conv), and 20 train steps as phase 5 but with BCE
   (pos_weight the batch's neg/pos), 4 + 4 + 9 + 9 launches per step
   (dualdense_unet 4 + 4 + 0 + 0), with the same gradient, loss, eval
   count and eval-after-step checks (attention_unet's four gate ``psi``
   conv biases, whose gradient is 0 by construction, need only be finite). Then phase 6's f32 train step, card
   against CPU, for unet_plain and attention_unet.
9. Three f32 train steps of unet_plain at 512^2, batch 8 (the paper
   pipeline's ``--no-amp``; the square convs on ``fma``, cuDNN's with TF32
   as PyTorch sets it by default): timed, finite, launch counts held.

Last, the ``kernels`` JSON line (unet_resnet50's entries, then the
families' under names of their own), the card line, and the result line.

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
# f32: summation order only (<= 4-term lerps; 9*C conv terms, C <= 1024).
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
# The families' kernel sites (phases 7-9). unet_plain and attention_unet:
# the square conv2 of each DoubleConv, (sites, C, H at 480^2, sites of that
# shape per forward); C^2 H^2, so the work, is the same at every level.
# dualdense_unet has the four upsamples only.
FAMILIES = ("unet_plain", "attention_unet", "dualdense_unet")
SAME_SITES = [("inc, up4.conv", 64, 480, 2), ("down1, up3.conv", 128, 240, 2),
              ("down2, up2.conv", 256, 120, 2), ("down3, up1.conv", 512, 60, 2),
              ("down4", 1024, 30, 1)]
FAMILY_UPSAMPLE_SITES = [("up1.up", 1024, 30), ("up2.up", 512, 60), ("up3.up", 256, 120),
                         ("up4.up", 128, 240)]
# At 512^2: (site, C, H_in, skip channels before the upsample's output in the cat).
FAMILY_UPSAMPLE_BWD_SITES = [("up1.up", 1024, 32, 512), ("up2.up", 512, 64, 256),
                             ("up3.up", 256, 128, 128), ("up4.up", 128, 256, 64)]
FAMILY_DGRAD_SITES = [(n, c, h * TRAIN_SIZE // SIZE, k) for n, c, h, k in SAME_SITES]
# Kernel launches per forward (predict) and per train step, by family.
FAMILY_FORWARD_LAUNCHES = {
    "unet_plain": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 9},
    "attention_unet": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 9},
    "dualdense_unet": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 0},
}
ZERO_GRADIENT_PARAMS = ("attn.psi.0.bias",)  # phase 8: finite, 0 by construction
FAMILY_TRAIN_STEPS = 20  # BCE falls within a few steps: mean of the last ten below the first ten
FAMILY_F32_STEPS = 3  # phase 9: unet_plain in f32 at full width, timed only
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


def _forward_case(kernel: str, c: int, h: int, dtype, gen: torch.Generator,
                  align_corners: bool = True, epilogue: bool = True):
    """(run, plain, library, nbytes, flops, path, x) of one forward site, batch 8.

    upsample2x: a random input, the upsample in ``align_corners``.
    conv3x3_same: with ``epilogue`` the fused relu(conv + bias) on a ReLU
    output (unet_resnet50's decoder); without, the bias-free conv alone
    (a DoubleConv's conv2) on a signed input, its output (BN's input)
    signed too. Weights fan-in scaled, float32 as the model holds them.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_bias_relu,
        conv3x3_bias_relu_plain,
        conv3x3_path,
        conv3x3_same,
        conv3x3_same_plain,
    )
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

    dev, cl = torch.device("cuda"), torch.channels_last
    x = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype)
    es = x.element_size()
    if kernel == "upsample2x":
        x = x.contiguous(memory_format=cl)
        run = lambda: upsample2x(x, align_corners)  # noqa: E731
        plain = lambda: upsample2x_plain(x, align_corners)  # noqa: E731
        library = lambda: F.interpolate(x, scale_factor=2, mode="bilinear",  # noqa: E731
                                        align_corners=align_corners)
        nbytes = x.numel() * es * 5  # read x once, write 4x
        flops = 9.0 * 4 * x.numel()  # 3 lerps of 3 FLOP per output element
        return run, plain, library, nbytes, flops, "staged", x
    x = (torch.relu(x) if epilogue else x).contiguous(memory_format=cl)
    w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
    nbytes = 2 * x.numel() * es + 9 * c * c * es
    flops = 2.0 * 9 * c * c * BATCH * h * h
    if epilogue:
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        wd, bd = w.to(dtype), b.to(dtype)
        run = lambda: conv3x3_bias_relu(x, w, b)  # noqa: E731
        plain = lambda: conv3x3_bias_relu_plain(x, w, b)  # noqa: E731
        library = lambda: F.conv2d(x, wd, bd, padding=1)  # noqa: E731
        nbytes += 4 * c
    else:
        wd = w.to(dtype)
        run = lambda: conv3x3_same(x, w)  # noqa: E731
        plain = lambda: conv3x3_same_plain(x, w)  # noqa: E731
        library = lambda: F.conv2d(x, wd, padding=1)  # noqa: E731
    return run, plain, library, nbytes, flops, conv3x3_path(c, dtype), x


@torch.no_grad()
def check_sites(gen: torch.Generator) -> list[dict]:
    """Phase 2: unet_resnet50's 11 forward sites at 480^2 (align_corners=True, fused epilogue)."""
    cases = [("upsample2x", f"up{c}x{h}", c, h, torch.bfloat16) for c, h in UPSAMPLE_SITES]
    cases.append(("upsample2x", "up64x240.f32", 64, 240, torch.float32))
    cases += [("conv3x3_same", n, c, h, torch.bfloat16) for n, c, h in CONV_SITES]
    cases.append(("conv3x3_same", "up_concat2.conv2.f32", 128, 120, torch.float32))
    rows = []
    for kernel, site, c, h, dtype in cases:
        run, plain, library, nbytes, flops, path, x = _forward_case(kernel, c, h, dtype, gen)
        rows.append(measure_site("site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops, {"shape": list(x.shape), "count": 1,
                                                 "sites_of": "unet_resnet50"}))
    return rows


@torch.no_grad()
def check_family_sites(gen: torch.Generator) -> list[dict]:
    """Phase 7: the families' forward sites at 480^2, align_corners=False, no epilogue.

    The bias-free conv at its 5 distinct DoubleConv shapes (9 sites, C = 64
    to 1024) and the upsample at its 4, bf16, plus one f32 case of each (the
    conv at C = 1024 on the CUDA cores, ``fma``). ``count`` is the number of
    sites of that shape in one forward.
    """
    cases = [("upsample2x", n, c, h, 1, torch.bfloat16) for n, c, h in FAMILY_UPSAMPLE_SITES]
    cases.append(("upsample2x", "up4.up.f32", 128, 240, 1, torch.float32))
    cases += [("conv3x3_same", n, c, h, k, torch.bfloat16) for n, c, h, k in SAME_SITES]
    cases.append(("conv3x3_same", "down4.f32", 1024, 30, 1, torch.float32))
    rows = []
    for kernel, site, c, h, count, dtype in cases:
        run, plain, library, nbytes, flops, path, x = _forward_case(
            kernel, c, h, dtype, gen, align_corners=False, epilogue=False)
        rows.append(measure_site("family_site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops, {"shape": list(x.shape), "count": count,
                                                 "sites_of": "families", "align_corners": False,
                                                 "epilogue": False}))
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


def _backward_case(kernel: str, c: int, h: int, skip: int, dtype, gen: torch.Generator,
                   align_corners: bool = True):
    """(run, plain, library, nbytes, flops, path, g) of one backward site, batch 8.

    upsample2x_backward: the gradient of an upsample of (C, H, H), channels
    [skip:] of the ``torch.cat`` gradient when ``skip`` (read in place).
    conv3x3_dgrad: a signed (C, H, H) gradient; its time includes packing
    the flipped weights.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_dgrad_plain,
        conv3x3_path,
    )
    from unet_embroidery_seg_torch.ops.upsample import (
        upsample2x_backward,
        upsample2x_backward_plain,
    )

    dev, cl = torch.device("cuda"), torch.channels_last
    if kernel == "upsample2x_backward":
        full = torch.randn(BATCH, skip + c, 2 * h, 2 * h, generator=gen)
        g = full.to(dev, dtype).contiguous(memory_format=cl)[:, skip:]
        run = lambda: upsample2x_backward(g, align_corners)  # noqa: E731
        plain = lambda: upsample2x_backward_plain(g, align_corners)  # noqa: E731
        library = lambda: torch.ops.aten.upsample_bilinear2d_backward(  # noqa: E731
            g, [2 * h, 2 * h], [BATCH, c, h, h], align_corners)
        nbytes = g.numel() * g.element_size() * 5 / 4  # read g once, write dx (a quarter of it)
        flops = 8.0 * g.numel()  # each g element feeds <= 4 dx elements, one FMA each
        return run, plain, library, nbytes, flops, "staged, cat slice" if skip else "staged", g
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
    return run, plain, library, nbytes, flops, conv3x3_path(c, dtype), g


def check_backward_sites(gen: torch.Generator) -> list[dict]:
    """Phase 3: unet_resnet50's 11 backward sites at 512^2 (align_corners=True)."""
    cases = [("upsample2x_backward", n, c, h, skip, torch.bfloat16)
             for n, c, h, skip in UPSAMPLE_BWD_SITES]
    cases.append(("upsample2x_backward", "up_conv.0.f32", 64, 256, 0, torch.float32))
    cases += [("conv3x3_dgrad", n, c, h, 0, torch.bfloat16) for n, c, h in DGRAD_SITES]
    cases.append(("conv3x3_dgrad", "up_concat2.conv2.f32", 128, 128, 0, torch.float32))
    rows = []
    for kernel, site, c, h, skip, dtype in cases:
        run, plain, library, nbytes, flops, path, g = _backward_case(kernel, c, h, skip, dtype, gen)
        rows.append(measure_site("backward_site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape),
                                  "count": 1, "sites_of": "unet_resnet50"}))
    return rows


def check_family_backward_sites(gen: torch.Generator) -> list[dict]:
    """Phase 7: the families' backward sites at 512^2, align_corners=False.

    The upsample backward at its 4 sites, each reading its channel slice of
    the cat gradient (skip widths 512, 256, 128, 64), and dgrad at the 5
    DoubleConv shapes (9 sites), bf16, plus one f32 case of each.
    """
    cases = [("upsample2x_backward", n, c, h, skip, 1, torch.bfloat16)
             for n, c, h, skip in FAMILY_UPSAMPLE_BWD_SITES]
    cases.append(("upsample2x_backward", "up4.up.f32", 128, 256, 64, 1, torch.float32))
    cases += [("conv3x3_dgrad", n, c, h, 0, k, torch.bfloat16) for n, c, h, k in FAMILY_DGRAD_SITES]
    cases.append(("conv3x3_dgrad", "down4.f32", 1024, 32, 0, 1, torch.float32))
    rows = []
    for kernel, site, c, h, skip, count, dtype in cases:
        run, plain, library, nbytes, flops, path, g = _backward_case(
            kernel, c, h, skip, dtype, gen, align_corners=False)
        rows.append(measure_site("family_backward_site", kernel, site, path, dtype, run, plain,
                                 library, nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape),
                                  "count": count, "sites_of": "families",
                                  "align_corners": False}))
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


def family_function_check(gen: torch.Generator) -> dict:
    """The families' autograd Functions on the card against the plain versions' autograd.

    conv3x3_same (no bias, no ReLU mask) at down2/up2's conv2 in training
    (256 channels, 128^2), dx and dW. upsample2x (align_corners=False) at
    attention_unet's up2 (512 channels, 64^2 -> 128^2): its output feeds
    both a concat after a 256-channel skip and a 1x1 conv (the gate's
    ``phi``), so autograd sums two gradients before the upsample's backward
    runs; ``grad_layout`` says whether that sum reached the kernel as a
    channels_last-like view (read in place) or needed a copy.
    Batch 8, bf16 activations, float32 parameters.
    """
    from unet_embroidery_seg_torch.ops import upsample as upsample_mod
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain

    dev, cl = torch.device("cuda"), torch.channels_last
    x = torch.randn(BATCH, 256, 128, 128, generator=gen).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=cl).requires_grad_()
    w = (torch.randn(256, 256, 3, 3, generator=gen) / (3 * 256 ** 0.5)).to(dev).requires_grad_()
    g = torch.randn(BATCH, 256, 128, 128, generator=gen).to(dev, torch.bfloat16)
    g = g.contiguous(memory_format=cl)
    got = torch.autograd.grad(conv3x3_same(x, w), (x, w), g)
    want = torch.autograd.grad(conv3x3_same_plain(x, w), (x, w), g)
    result = {}
    for name, a, r in zip(("conv_same_dx", "conv_same_dW"), got, want):
        result[name] = {"max_abs_err": (a.float() - r.float()).abs().max().item(),
                        "tol": TOL_FUNCTION * r.float().abs().max().item()}

    u = torch.randn(BATCH, 512, 64, 64, generator=gen).to(dev, torch.bfloat16)
    u = u.contiguous(memory_format=cl).requires_grad_()
    skip = torch.randn(BATCH, 256, 128, 128, generator=gen).to(dev, torch.bfloat16)
    skip = skip.contiguous(memory_format=cl)
    phi = (torch.randn(128, 512, 1, 1, generator=gen) / 512 ** 0.5).to(dev, torch.bfloat16)
    phi = phi.contiguous(memory_format=cl)
    g_cat = torch.randn(BATCH, 768, 128, 128, generator=gen).to(dev, torch.bfloat16)
    g_phi = torch.randn(BATCH, 128, 128, 128, generator=gen).to(dev, torch.bfloat16)
    g_cat, g_phi = g_cat.contiguous(memory_format=cl), g_phi.contiguous(memory_format=cl)
    layouts = []

    def probe(grad):
        layouts.append({"in_place": upsample_mod._pixel_strides(grad) is not None,
                        "channels_last": grad.is_contiguous(memory_format=cl),
                        "stride": list(grad.stride())})

    def du(up):
        y = up(u, False)
        y.register_hook(probe)
        outs = (torch.cat([skip, y], 1), F.conv2d(y, phi))
        return torch.autograd.grad(outs, u, (g_cat, g_phi))[0]

    du_kernel, du_ref = du(upsample_mod.upsample2x), du(upsample_mod.upsample2x_plain)
    result["upsample_summed_dx"] = {
        "max_abs_err": (du_kernel.float() - du_ref.float()).abs().max().item(),
        "tol": TOL_BF16 * du_ref.float().abs().max().item(), "grad_layout": layouts[0]}
    print("family_function_check " + json.dumps(result), flush=True)
    for name, r in result.items():
        if not (np.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= r["tol"]):
            raise AssertionError(f"autograd Function {name}: {r}")
    return result


def main_path(counters, name: str = "unet_resnet50", per_forward: dict | None = None) -> dict:
    """Predict 16 seeded letterboxed 480^2 canvases with full-width ``name``, batches of 8, bf16.

    Launch counters are zeroed just before and read just after; each must
    be ``per_forward`` times the forwards.
    """
    from unet_embroidery_seg_torch.data.synthetic import letterboxed_canvases
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.predict import predict_probs

    per_forward = per_forward or {"upsample2x": 5, "conv3x3_bias_relu": 6}
    model = build_model(name, 2, generator=torch.Generator().manual_seed(0))
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
    want = {k: v * forwards for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != expected {want}")
    p = np.concatenate(probs)
    if p.shape != (2 * BATCH, SIZE, SIZE, 2) or not np.isfinite(p).all():
        raise AssertionError(f"bad softmax: shape {p.shape}, finite {np.isfinite(p).all()}")
    sum_err = float(np.abs(p.sum(-1) - 1.0).max())
    if sum_err > 1e-5:  # f32 softmax of f32 logits
        raise AssertionError(f"softmax sums off by {sum_err}")
    result = {"model": name, "batch_ms": batch_ms, "launches": launches,
              "softmax_sum_err": sum_err, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
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


def train_path(counters, name: str = "unet_resnet50", loss: str = "lovasz_hinge",
               steps: int = TRAIN_STEPS, per_step: dict | None = None, amp: bool = True,
               checks: bool = True) -> dict:
    """``steps`` train steps of full-width ``name`` at 512^2, batch 8, on one seeded batch.

    Binary, diff head, Adam over float32 masters at the CLI's lr; bf16
    autocast unless ``amp`` is off. BCE takes the batch's neg/pos as its
    pos_weight (the CLI's auto rule). Counters are zeroed just before the
    timed steps and read just after: each must be ``per_step`` times the
    steps. Then, with ``checks``: every parameter has a finite gradient that
    is nonzero somewhere, the loss falls (mean of the last ten below the
    first ten), one eval step's counts sum to 8 * 512^2, and an eval forward
    after one more step (grad off: the packed-weight cache) equals a fresh
    model's. Without ``checks`` only finite losses and the counts are held.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules

    per_step = per_step or {"upsample2x": 5, "upsample2x_backward": 5, "conv3x3_bias_relu": 6,
                            "conv3x3_dgrad": 6}
    model = build_model(name, 2, diff_head=True, generator=torch.Generator().manual_seed(0))
    opt = schedules.make_train_optimizer(model.parameters(), TRAIN_LR)
    batch = seeded_train_batch(BATCH, TRAIN_SIZE, seed=0)
    pos_weight = None
    if loss == "bce":
        pos = float(batch[1].sum())
        pos_weight = (batch[1].size - pos) / pos
    step = make_binary_train_step(model, opt, loss, pos_weight, amp=amp)
    losses = [float(step(*batch))]  # warm-up: cuDNN plans, kernel loads, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for c in counters:
        c.launches = 0
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))  # float() waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{name}: train launches {launches} != expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    result = {
        "model": name, "steps": steps, "size": TRAIN_SIZE, "batch": BATCH, "loss": loss,
        "pos_weight": pos_weight, "lr": TRAIN_LR, "amp": amp,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms, "graph_replay_ms": None,
        "losses": losses, "launches": launches, "launches_per_step": {
            k: v / steps for k, v in launches.items()},
        "params_with_grad": sum(1 for _ in model.parameters()), "peak_mem_gb": peak_gb,
    }
    if checks:
        result.update(_train_checks(model, step, batch, name, loss, pos_weight, losses))
    print("train_path " + json.dumps(result), flush=True)
    return result


def _train_checks(model, step, batch, name, loss, pos_weight, losses) -> dict:
    from unet_embroidery_seg_torch.engine.steps import make_binary_eval_step
    from unet_embroidery_seg_torch.models import build_model

    # A conv bias right before train-mode BN (attention_unet's gate ``psi``)
    # has a gradient of 0 but for rounding: BN removes any constant shift.
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or not (p.grad.any() or n.endswith(ZERO_GRADIENT_PARAMS))]
    if no_grad:
        raise AssertionError(f"{name}: {len(no_grad)} parameters without a finite nonzero "
                             f"gradient: {no_grad[:5]}")
    # Lovasz at this init sits near 1.0 for ~40 steps, then falls with
    # single-step spikes: the mean of the last ten against the first ten.
    if not np.mean(losses[-10:]) < np.mean(losses[:10]):
        raise AssertionError(f"{name}: the loss did not fall on a fixed batch: {losses}")

    _, counts = make_binary_eval_step(model, loss, pos_weight)(*batch)
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
    fresh = build_model(name, 2, diff_head=True)
    fresh.load_state_dict(model.state_dict(), strict=True)
    changed = (after - before).abs().max().item()
    stale = (after - forward(fresh)).abs().max().item()
    if not (changed > 0 and stale <= 0.1 * changed):
        raise AssertionError(f"{name}: eval after a step: changed by {changed}, off a fresh "
                             f"model by {stale}")
    return {"eval_counts": counts.tolist(),
            "eval_after_step": {"changed": changed, "off_fresh": stale}}


def _f64_train_grads(name: str, state: dict, images, pngs, sm) -> tuple[float, dict]:
    """Loss and gradients of one BCE train step in float64 on the CPU: the exact reference.

    The model in float64 with its two kernel sites as stock PyTorch ops
    (``F.conv2d``, ``F.interpolate``: the plain versions compute in float32
    by design), independent of the code under test.
    """
    from unet_embroidery_seg_torch.models import blocks, build_model
    from unet_embroidery_seg_torch.ops import losses

    model = build_model(name, 2, diff_head=True, device="cpu").double()
    model.load_state_dict(state, strict=True)
    model.train()
    kernels = blocks.conv3x3_same, blocks.upsample2x
    blocks.conv3x3_same = lambda x, w: F.conv2d(x, w, padding=1)
    blocks.upsample2x = lambda x, a: F.interpolate(x, scale_factor=2, mode="bilinear",
                                                   align_corners=a)
    try:
        out = model(torch.from_numpy(images).double().permute(0, 3, 1, 2))
    finally:
        blocks.conv3x3_same, blocks.upsample2x = kernels
    loss = losses.binary_segmentation_loss(out, torch.from_numpy(pngs), "bce", pos_weight=3.0,
                                           sample_mask=torch.from_numpy(sm))
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in model.named_parameters()}


def f32_train_card_vs_cpu(name: str = "unet_resnet50") -> dict:
    """One f32 train step (BCE, pos_weight 3) of full-width ``name`` at 128^2, batch 2: card against CPU.

    Four runs from one state: the CPU, the CPU with every input pixel moved
    by about one f32 ulp up (x (1 + 2^-23)) and down (x (1 - 2^-23)), and
    the card. The larger of the two moves, per gradient, is this model's f32
    noise floor, which the card is held to. unet_resnet50's kernel sites
    (its BN-free decoder) are also held to a fixed 1e-2.

    The families add a fifth run, the step in float64 (``_f64_train_grads``):
    their one-ulp moves fall short of the CPU's own f32 error (attention_unet:
    a median 0.14% move, against 1.6% between the CPU's f32 step and the
    float64 one), so their floor per gradient is the larger of the two; the
    gradient the card moves most is held to its own floor, among those
    the CPU's f32 computes to better than 100% (attention_unet's four gate
    ``psi`` conv biases have a gradient of exactly 0, BN following them,
    and are left out by name in the report); and the card's distance from
    float64 is held to 4x the CPU's. Their square convs sit between BNs, so
    only the floor holds them.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules

    state = build_model(name, 2, diff_head=True, device="cpu",
                        generator=torch.Generator().manual_seed(3)).state_dict()
    images, pngs, sm = seeded_train_batch(2, 128, seed=3)
    runs = {"cpu": ("cpu", images), "cpu_up": ("cpu", images * np.float32(1 + 2.0 ** -23)),
            "cpu_down": ("cpu", images * np.float32(1 - 2.0 ** -23)), "card": ("cuda", images)}
    loss, grads = {}, {}
    for run, (dev, imgs) in runs.items():
        model = build_model(name, 2, diff_head=True, device=dev)
        model.load_state_dict(state, strict=True)
        opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
        loss[run] = float(make_binary_train_step(model, opt, "bce", 3.0, amp=False)(imgs, pngs, sm))
        grads[run] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    exact = name != "unet_resnet50"
    if exact:
        loss["cpu_f64"], grads["cpu_f64"] = _f64_train_grads(name, state, images, pngs, sm)

    def rel(run: str, ref: str = "cpu") -> dict:
        return {n: ((g - grads[ref][n]).norm() / grads[ref][n].norm().clamp_min(1e-30)).item()
                for n, g in grads[run].items()}

    card, up, down = rel("card"), rel("cpu_up"), rel("cpu_down")
    noise = {n: max(up[n], down[n]) for n in card}
    result, live = {"model": name}, list(card)
    if exact:
        cpu_err, card_err = rel("cpu", "cpu_f64"), rel("card", "cpu_f64")
        noise = {n: max(noise[n], cpu_err[n]) for n in card}
        live = [n for n in card if cpu_err[n] < 1.0]
        result.update({"loss_cpu_f64": loss["cpu_f64"],
                       "median_grad_rel_err_cpu_vs_f64": statistics.median(cpu_err.values()),
                       "median_grad_rel_err_card_vs_f64": statistics.median(card_err.values()),
                       "zero_gradient_params": sorted(set(card) - set(live))})
    worst = max(live, key=card.get)
    if name == "unet_resnet50":
        sites = [n for n in card
                 if n.startswith("up_conv.") or (n.startswith("up_concat") and ".conv2." in n)]
    else:  # the DoubleConvs' conv2, reported only
        sites = [n for n in card if n.endswith("net.3.weight")]
    result.update({"loss_card": loss["card"], "loss_cpu": loss["cpu"],
                   "loss_cpu_up": loss["cpu_up"], "loss_cpu_down": loss["cpu_down"],
                   "loss_rel_diff": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
                   "median_grad_rel_diff": statistics.median(card.values()),
                   "median_grad_rel_noise": statistics.median(noise.values()),
                   "worst_grad_rel_diff": card[worst], "worst_grad_param": worst,
                   "worst_grad_rel_noise": noise[worst] if exact else max(noise.values()),
                   "kernel_site_grad_rel_diff": {n: card[n] for n in sites}})
    print("f32_train_card_vs_cpu " + json.dumps(result), flush=True)
    floor = lambda v: TOL_TRAIN_NOISE_FACTOR * v + TOL_F32_GRAD  # noqa: E731
    if not (np.isfinite(list(card.values())).all()
            and result["loss_rel_diff"] <= TOL_TRAIN_LOSS
            and (name != "unet_resnet50" or max(card[n] for n in sites) <= TOL_TRAIN_GRAD_SITES)
            and result["median_grad_rel_diff"] <= floor(result["median_grad_rel_noise"])
            and card[worst] <= floor(result["worst_grad_rel_noise"])
            and (not exact or result["median_grad_rel_err_card_vs_f64"]
                 <= floor(result["median_grad_rel_err_cpu_vs_f64"]))):
        raise AssertionError(f"f32 train step card vs CPU disagree: {result}")
    return result


def packing_cost() -> dict:
    """Card and host cost of packing the families' conv weights in one train step.

    With grad on, each of the 9 DoubleConv sites packs its weight for the
    forward and its flipped, transposed weight for dgrad on every call:
    float32 OIHW in, bf16 in the kernel's layout out (~31 MB written per
    pass). ``card_ms`` by graph replay of all 18 packs; ``host_ms`` the time
    the host takes to issue them (the card's queue not waited on).
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import _dgrad_weight, pack_conv3x3_weight
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    gen = torch.Generator().manual_seed(6)
    weights = [torch.randn(c, c, 3, 3, generator=gen).cuda()
               for _, c, _, k in SAME_SITES for _ in range(k)]

    def pack_all():
        for w in weights:
            pack_conv3x3_weight(w, torch.bfloat16)
            pack_conv3x3_weight(_dgrad_weight(w), torch.bfloat16)

    eager = event_ms(pack_all)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack_all()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    n = sum(w.numel() for w in weights)
    result = {"sites": len(weights), "packs_per_step": 2 * len(weights),
              "bytes_written_per_step": 2 * 2 * n, "bytes_read_per_step": 2 * 4 * n,
              "card_ms": graph_ms(pack_all, eager), "eager_ms": eager,
              "host_ms_median": statistics.median(host)}
    print("packing_cost " + json.dumps(result), flush=True)
    return result


KERNEL_META = {  # name -> (source, TPU kernel it replaces, launch counter)
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
# The families' entries: the same kernels at their new sites, under names of their own.
FAMILY_KERNELS = {
    "upsample2x[align_corners=False]": ("upsample2x", "upsample2x"),
    "upsample2x_backward[align_corners=False]": ("upsample2x_backward", "upsample2x_backward"),
    "conv3x3_same[no epilogue]": ("conv3x3_same", "conv3x3_same"),
    "conv3x3_dgrad[DoubleConv]": ("conv3x3_dgrad", "conv3x3_dgrad"),
}


def _summary_entry(name: str, kernel: str, rows: list[dict], launches: int, sites: str) -> dict:
    """One ``kernels`` entry: a pass over the bf16 sites of ``kernel`` in ``rows``.

    A pass runs its sites one after another, each ``count`` times, so its
    times and its bound are the counted sums of theirs; bound_by names the
    limit behind most of that bound.
    """
    source, replaces, _ = KERNEL_META[kernel]
    mine = [r for r in rows if r["kernel"] == kernel]
    bf16 = [r for r in mine if r["dtype"] == "torch.bfloat16"]

    def total(key):
        return sum(r[key] * r["count"] for r in bf16)

    share: dict[str, float] = {}
    for r in bf16:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["bound_ms"] * r["count"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms_method": MS_METHOD, "ms": total("ms"), "eager_ms": total("eager_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": sum(share.values()),
        "bound_by": max(share, key=share.get), "library_ms": total("library_ms"),
        "library_eager_ms": total("library_eager_ms"), "sites": sites,
    }


def kernel_summary(rows: list[dict], launches: dict, family_rows: list[dict],
                   family_launches: dict) -> list[dict]:
    """Every kernel entry: unet_resnet50's sites, then the families' sites.

    ``launches`` are unet_resnet50's train path's counts; ``family_launches``
    the three families' train paths' counts summed.
    """
    out = []
    for kernel, (_, _, counter) in KERNEL_META.items():
        where = "480^2 forward" if kernel in ("upsample2x", "conv3x3_same") else "512^2 backward"
        out.append(_summary_entry(kernel, kernel, rows, launches[counter],
                                  f"unet_resnet50, {where}"))
    for name, (kernel, counter) in FAMILY_KERNELS.items():
        where = "480^2 forward" if kernel in ("upsample2x", "conv3x3_same") else "512^2 backward"
        out.append(_summary_entry(name, kernel, family_rows, family_launches[counter],
                                  f"unet_plain, attention_unet, dualdense_unet, {where}"))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the full report as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from unet_embroidery_seg_torch.ops import _build
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad, conv3x3_same
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

    forward_counters = [upsample2x, conv3x3_bias_relu, conv3x3_same]
    train_counters = [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_same,
                      conv3x3_dgrad]
    family_rows = check_family_sites(torch.Generator().manual_seed(7))
    family_rows += check_family_backward_sites(torch.Generator().manual_seed(8))
    family_functions = family_function_check(torch.Generator().manual_seed(9))
    packing = packing_cost()
    families = {}
    for name in FAMILIES:
        per_forward = FAMILY_FORWARD_LAUNCHES[name]
        per_step = {**per_forward, "upsample2x_backward": per_forward["upsample2x"],
                    "conv3x3_dgrad": per_forward["conv3x3_same"]}
        families[name] = {
            "predict": main_path(forward_counters, name, per_forward),
            "train": train_path(train_counters, name, "bce", FAMILY_TRAIN_STEPS, per_step),
        }
        torch.cuda.empty_cache()
    for name in ("unet_plain", "attention_unet"):
        families[name]["f32_train_card_vs_cpu"] = f32_train_card_vs_cpu(name)
    # The paper pipeline's --no-amp run: f32 convs, cuDNN's with TF32 as
    # PyTorch has it by default (the train CLI does not change it).
    torch.backends.cudnn.allow_tf32 = True
    f32_full = train_path(train_counters, "unet_plain", "bce", FAMILY_F32_STEPS,
                          {**FAMILY_FORWARD_LAUNCHES["unet_plain"], "upsample2x_backward": 4,
                           "conv3x3_dgrad": 9}, amp=False, checks=False)
    torch.backends.cudnn.allow_tf32 = False
    family_launches = {c.__name__: sum(f["train"]["launches"][c.__name__]
                                       for f in families.values())
                       for c in train_counters}
    kernels = kernel_summary(rows + bwd_rows, train["launches"], family_rows, family_launches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "sites": rows,
                       "weight_update": update, "backward_sites": bwd_rows,
                       "function_check": functions, "main_path": path, "train_path": train,
                       "f32_card_vs_cpu": f32, "f32_train_card_vs_cpu": f32_train,
                       "family_sites": family_rows, "family_function_check": family_functions,
                       "packing_cost": packing, "families": families,
                       "f32_full_width_train": f32_full,
                       "kernels": kernels, "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
