#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which raises on failure (the script exits 0 only if all pass):

1. Print the card's name and power limit; build the three CUDA kernel
   libraries from ``unet_embroidery_seg_torch/csrc`` (one nvcc each, in
   parallel).
2. Forward sites: at each of the 11 kernel sites of unet_resnet50 at 480^2,
   batch 8, bf16 (5 upsample, 6 square conv3x3), plus one f32 case per
   kernel (the conv's on ``tf32x3``, the CUDA-core ``fma`` kernel timed on
   the same call as ``fma_ms``): hold the kernel against its plain PyTorch version and time
   kernel, plain version and the library call that computes the same
   function (``F.interpolate``, ``F.conv2d``; the port never calls either)
   with CUDA events, grad off as in predict. ``ms`` and ``library_ms`` are
   the card's own time, by CUDA-graph replay (``ms_method``); ``eager_ms``
   and ``library_eager_ms`` are the same calls back to back from the host,
   dispatch included; ``plain_ms`` is eager. Each row names the kernel path
   taken (conv: ``c64_persistent``, ``wgmma``, ``tf32x3_c64`` (f32, C <= 64),
   ``tf32x3`` or ``fma``) and its TFLOP/s and share of the bound, both from
   ``ms``; the f32 tensor-core rows (``tf32x3_c64``, ``tf32x3``) are bound at
   the 3xTF32 rate (495/3 TFLOP/s), with the CUDA cores' 67 TFLOP/s bound
   beside it (``cuda_core_bound_ms``). A ``wgmma`` row (bf16, C > 64) also
   gives its thread-block cluster size (``cluster``) and the weight bytes
   its launch reads from L2 (``l2_weight_bytes``, counted from the schedule
   by ``ops/conv3x3.py:streamed_schedule``) and their rate over ``ms``
   (``l2_weight_bytes_per_s``); a ``c64_persistent`` row (bf16, C <= 64) its
   tile (TH, TW), items, items per CTA, halo pitch and the share of its MMA
   columns computed and dropped (``ops/conv3x3.py:c64_schedule``). Then an
   in-place weight update
   between two conv calls on signed inputs must change the result (the
   wrapper's packed-weight cache repacks).
3. Backward sites, at the train shapes (512^2, batch 8, bf16) plus one f32
   case per kernel (dgrad's on ``tf32x3``, ``fma`` beside it): upsample2x's backward at its 5 sites (the four decoder
   ones read their gradient as a channel slice of ``torch.cat``'s, in
   place) and conv3x3's dgrad at its 6, each against its plain version and
   timed like phase 2. dgrad reads the forward's grad-mode packing
   (``pack_conv3x3_grad``), made once, so its ``ms`` is the kernel's
   alone; each dgrad row also holds it bit for bit against the composition
   that packed the flipped weights per call, and times that composition
   (``flipped_ms``), its pack (``flipped_pack_ms``) and the grad-mode pack
   (``grad_pack_ms``). Library yardsticks: ``aten.upsample_bilinear2d_backward`` and
   ``torch.nn.grad.conv2d_input``. Then, at one site of each kernel, the
   autograd Function's gradients against the plain version's autograd.
   3c: two bf16 train stages' forward + dx captured in a CUDA graph, their
   weights changed in place, replayed: dx equals eager's on the new weights
   (``dgrad_graph_check``).
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

7. Forward sites at 480^2, batch 8, as phase 2: the bias-free conv at its
   5 distinct shapes (9 sites, C = 64 to 1024, signed inputs) in bf16 and
   in f32 (``tf32x3``, ``fma`` beside it), the upsample at its 4 sites in
   bf16 plus one f32 case, and the ``fma`` kernel at C = 130 (which no
   tensor-core path takes) in f32 and bf16; yardsticks ``F.conv2d``
   without bias (TF32 off) and ``F.interpolate(align_corners=False)``.
   Backward sites at 512^2 as phase 3: the upsample backward at its 4 sites
   (channel slices of cat gradients after skips of 512, 256, 128 and 64)
   plus one f32 case, dgrad at the 5 shapes in bf16 and in f32 (``tf32x3``,
   ``fma`` beside it). The Functions' gradients against plain
   autograd: the bias-free conv's dx and dW; the upsample's dx where its
   output feeds both a concat and a 1x1 conv (attention_unet's gate), with
   the layout in which that summed gradient reaches the kernel. Then the
   packs of one train step, counted (unet_plain 9, unet_resnet50 6, all in
   the forward, none in the backward), and their card and host cost at the
   9 sites in bf16 and f32 beside the 18 packs of the flipped composition
   (``packing_cost``); the f32 grad-mode pack kernel
   (``conv3x3_pack_tf32x3``) at the 5 shapes, bit for bit.
8. For each family, full width, seeded weights: predict as phase 4 (4
   upsample and 9 bias-free conv launches per forward; dualdense_unet 4
   and 0; no fused conv), and 20 train steps as phase 5 but with BCE
   (pos_weight the batch's neg/pos), 4 + 4 + 9 + 9 launches per step
   (dualdense_unet 4 + 4 + 0 + 0), with the same gradient, loss, eval
   count and eval-after-step checks (attention_unet's four gate ``psi``
   conv biases, whose gradient is 0 by construction, need only be finite). Then phase 6's f32 train step, card
   against CPU, for unet_plain and attention_unet.
9. Three f32 train steps of unet_plain at 512^2, batch 8 (the paper
   pipeline's ``--no-amp``; the square convs on ``tf32x3``, cuDNN's with
   TF32 as PyTorch sets it by default and the CLIs state it): timed,
   finite, launch counts held.

Phase 10 takes multitask_unet (unet_resnet50's decoder: the same 5
align_corners=True upsamples and 6 fused convs) and the multiclass task
(K = 5 output classes) to the card:

- f32 site rows at the train shapes (512^2, batch 8, TF32 off for the
  library calls): the align_corners=True upsample forward and backward at
  its 5 sites, the fused conv (``tf32x3``, ``fma`` beside it) at its 6 and
  their dgrad, each against its plain version;
- 10a. multitask_unet in bf16: 20 train steps through the port's multitask
  step (seg BCE unweighted, class CE, dropout on), 5 + 5 + 6 + 6 launches
  per step, the gradient, loss, eval (seg counts within their bounds, the
  class confusion sums to 8) and eval-after-step checks of phase 5;
- 10b. the paper pipeline's ``--no-amp``: 3 f32 steps each of
  multitask_unet and of multiclass unet_resnet50 with CE + Dice and with
  Focal + Dice, timed, finite, launch counts held, the fused sites on
  ``tf32x3_c64`` (C = 64, three) and ``tf32x3`` (three);
- 10c. multiclass unet_plain in bf16, CE + Dice, 20 steps (4 + 4 + 9 + 9
  launches), with the checks of 10a (the eval step's four metrics in
  [0, 1]);
- 10d. multitask_unet in f32 at 128^2, batch 2, dropout off: seg and class
  logits, the loss triple and every gradient, card against the CPU, to
  phase 6's rule.

Phase 11 takes the device-resident input path (the train and val CLIs'
default on the card) to it: a seeded split of 64 uint8 canvases at 512^2
(``data/synthetic.resident_canvases``, no PIL), uploaded once:

- 11a. Eight canvases augmented on the card and on the CPU from the same
  parameters (drawn on the card, copied to the CPU): images within 1e-5,
  masks equal but where a source coordinate lies within 1e-4 of a ``.5``
  rounding boundary (under 1e-4 of the pixels); the gather + augmentation
  per batch of 8 timed by CUDA events, eagerly (the host's dispatch and
  the draw included) and by graph replay on fixed parameters (the card's
  own time);
- 11b. unet_resnet50, binary, Lovasz, bf16, batch 8, through
  ``engine/resident.make_train_chunk_fn``: a warm-up chunk, then two timed
  chunks of 8 steps (counters zeroed just before, read just after: 5 + 5 +
  6 + 6 launches per step; finite losses; every parameter has a gradient),
  step ms by CUDA events from one step's start to the next's, the card's
  busy ms per step in a third, profiled chunk (and its card time by kernel
  group) over the step median, resident bytes and peak memory; beside
  them, on the same line,
  the host-fed step (one numpy batch copied per step, the loss read per
  step) of the same model; and, augmentation off, the chunk's losses
  against the host-fed loop's on the same batches (rtol 1e-3);
- 11c. 8 multitask_unet bf16 steps on the resident path: launches as 11b,
  finite losses;
- 11d. the resident eval chunk's counts against the host-fed eval step's
  on the same canvases, exactly.

Phase 12 takes data parallelism (the JAX mesh's ``data`` axis: DDP, the
BatchNorm synchronised over the process group, global-batch losses) to the
card; a 1-rank NCCL group stands in for the CLI's backend on one card:

- 12a. The synchronised BN (1-rank NCCL group) against the port's cuDNN BN
  at ResNet-50's layer1 ``bn3`` shape at 512^2, batch 8 (256 channels at
  128^2), f32 and bf16: output, input, weight and bias gradients, running
  mean and variance, each copied right after one call; forward + backward
  then timed for both; each side's calls and the f32 dx ratio range
  printed;
- 12b. Two ranks on the one card (gloo with CUDA tensors: NCCL refuses two
  ranks on one device; the kernels built before the ranks start):
  unet_resnet50 at 512^2, global batch 8 (4 + 4), diff head, Lovasz. f32,
  one SGD step against the 1-process step on the same batch: the loss to
  1e-5, each parameter's update and each BN statistic, as a share of its
  norm, to 4x the floor of this model (the 1-process step with its input
  moved by one ulp, measured in the same run), and the two ranks'
  parameters and statistics bit-equal after the step. bf16, Adam, a
  resident chunk of 8 steps: losses against the 1-process chunk within
  11b's rtol 1e-3; launches per rank (5 + 5 + 6 + 6 per step), ms/step
  and peak memory per rank in a second chunk;
- 12c. DDP over NCCL at world size 1 on ``cuda:0``: the resident bf16
  chunk (DDP, synchronised BN) against the unwrapped step's from the same
  weights (first loss within 1e-3), ms/step by CUDA events and card busy
  ms per step (profiled) beside the unwrapped step's: the difference is
  DDP's overhead and the synchronised BN's;
- 12d. Where the machine has two cards or more: the train CLI with
  ``--mesh-data 2`` over NCCL for a few steps (one ``expN``, its files),
  and 12b's bf16 chunk on two cards (4 + 4) with its ms/step beside one
  card's; with one card, a line saying that it did not run and why.
  ``--multi-card-only`` runs the build and 12d alone.

Phase 13 takes the tooling to the card: the kernels as registered operators
(``unet_seg::*``, ``ops/library.py``), the ``torch.export`` serving artifact
that runs them, and the train CLI's ``--profile``:

- 13a. ``torch.library.opcheck`` of each of the five operators at one site
  shape (batch 8), in bf16 and in f32: schema, fake against real (shape,
  dtype, strides), AOT dispatch with dynamic shapes;
- 13b. full-width unet_resnet50 (seeded weights saved to a ``.pth``)
  exported through ``export_serving.main`` (``--check``) at 480^2 for
  batches 1 and 8 on ``cuda``, bf16; each artifact loaded with
  ``load_artifact`` and run on phase 4's 16 canvases against
  ``predict_probs`` on the eager model (within 1e-3, the ``--check``
  rule); 5 upsample and 6 fused-conv launches per artifact forward and no
  other; the operators each forward dispatches (artifact, eager, and the
  program as ``torch.export`` gives it, its metadata asserts kept): the
  artifact's no more than eager's; artifact and eager serving forward
  timed per batch in turns (median card ms per call by CUDA events, host
  ms per call), the artifact's bytes;
- 13c. the same for one ``--no-amp`` (f32) artifact at batch 1, the
  fused sites on ``tf32x3_c64`` and ``tf32x3``;
- 13d. the train CLI with ``--profile`` (resident path, unet_resnet50,
  512^2, batch 8, chunks of 2): the trace file parses and holds, in its
  window (chunk 1: 2 steps), exactly 2 x (5, 5, 6, 6) CUDA kernels of the
  upsample forward and backward, the fused conv forward and its dgrad, and
  as many ``unet_seg::`` operator events; its ``HBM:`` line shows memory
  in use;
- 13e. the host cost of the operators' dispatch: host us per call of each
  operator against its CUDA implementation called directly, and 11b's
  resident chunk in ms/step through the operators and with the Functions
  calling the CUDA implementations directly (direct, operators, operators,
  direct), beside 11b's figure of this run;
- 13f. the ``--no-bake-weights`` artifact (bf16, batch 1): exported on the
  card (``--check``), loaded, called with the model's state dict on phase
  4's 16 canvases against eager ``predict_probs`` (the ``--check`` rule),
  5 + 6 launches per forward.

Phase 14 drives the paper pipeline (``python -m
unet_embroidery_seg_torch.pipeline``, ``run.sh``'s stages through the
port) in process on ``synthetic:16`` at 512^2, batch 8, full width, one
epoch of two steps a fit, ``--no-amp`` as ``run.sh`` trains: binary with
every stage (10 fits), multiclass to stage 1 (2), multitask (1). The
counts are set to 0 before it and read after. It fails unless each leg's
``expN/config.json`` sequence of (task, model, loss) is ``pipeline.plan``'s
with the winner picked, every run is f32 on the card, the tables hold a
row per fit (multitask renders none, as ``run.sh``), every square conv
site is on ``tf32x3_c64`` or ``tf32x3``, the f32 upsample (forward, backward) and conv
(fused and bias-free forward, dgrad) all launched, and each fit's counts
are its family's sites times its model forwards (backward: its train
steps, 2). Prints each leg's seconds per fit.

Phase 15 runs one seed of ``scripts/torch_parity_study.py``'s bf16
unet_resnet50 + Lovasz arm for 2 epochs at 256^2: the study writes its
data tree (parquet where ``datasets`` is installed, else VOC), checks that
the CLI opens it and not the synthetic fallback, and the JSON entry must
hold a finite test IoU from a bf16 run that launched the kernels.

Phase 16 drives the mesh's space axis (``--mesh-space``, ``parallel/halo.py``):
16a holds the kernels' halo-padded (conv: forward and dgrad) and band
(upsample: forward and backward) modes at unet_resnet50's 11 sites at
512^2, batch 8, each image's rows split in two, bf16 and f32: each shard
against its plain version, the shards together against the unsplit kernel
(forward exactly, backward within one more rounding), each shard timed
beside ``F.conv2d`` with padding (0, 1) on the same input or
``F.interpolate`` on the band, with its bound. 16b runs two gloo ranks on
the one card as a 1x2 mesh against one process: the f32 SGD step (12b's
rule), f32 eval counts exactly (the seeded weights), the bf16 eval's
logits and predictions within 4x the floor of a one-ulp input move, 6 bf16
Lovasz steps per rank with 5 + 5 + 6 + 6 launches per step, every one in
its halo or band mode, the exchange's collectives per step, ms/step,
the card's busy ms per step (2 profiled steps) and peak memory beside one
process's. 16c (``--multi-card-only``, four
cards): the train CLI with ``--mesh-data 2 --mesh-space 2`` over NCCL
writes ``expN``, and the 1x2 steps run over NCCL on two cards; with fewer
cards it prints why it did not run.
17. The space axis for the other families and tasks, a 1x2 mesh. 17a: 16a
at the families' sites (512^2, batch 8, bf16 and f32): the bias-free conv's
halo mode at its 5 DoubleConv shapes (9 sites), forward and dgrad, and the
align_corners=False band upsample at its 4 sites, forward and backward,
each shard against its plain version and the shards against the unsplit
kernel, timed beside bound and library. 17b: two gloo ranks on the one card
(one job) against one process for unet_plain, attention_unet and
dualdense_unet (binary BCE), unet_plain multiclass (K = 5, CE + Dice) and
multitask_unet: one f32 SGD step to 12b's rule, the f32 eval results
exactly, 3 bf16 steps per rank with every launch in its halo or band mode
(4 + 4 + 9 + 9, dualdense 4 + 4 + 0 + 0, multitask 5 + 5 + 6 + 6 per step),
ms/step and peak memory per rank beside one process's. 17c
(``--multi-card-only``, four cards): the train CLI on a 2x2 mesh for
unet_plain multiclass and multitask_unet, one ``expN`` each.
18. The JAX package's alternates (``tests/torch_alternates.py``: none is an
option of the port), each against the port's default, at full width.
18a: unet_resnet50's final stage (``up_conv``: 64 channels at 256^2
upsampled to 512^2, two fused 3x3 convs, the 1x1 head; batch 8) packed
(cuDNN's 2x2 convs over 256 packed channels) against unpacked (the
upsample and conv kernels, the head), f32 (TF32 off) within 1e-4 of the
largest logit (the first conv's dW: its distance from the stage in
float64 within 4x the unpacked dW's, plus 1e-4) and bf16 within
``TOL_PACKED_BF16_FACTOR`` x the unpacked bf16 tail's own distance from
its f32 tail (measured in the run; its dW alike by the largest element,
and by the norm within ``TOL_PACKED_BF16_DW_NORM_FACTOR`` x); forward
and forward + backward ms of each, graph replay and eager. 18b:
the ResNet stem at 512^2, batch 8, in each ``StemConv7x7`` mode, bf16 and
f32: forward against ``direct`` (f32: 1e-4; bf16: one bf16 ulp) and dW
(f32: phase 6's rule, 4x the floor of ``direct``'s dW with its input moved
one ulp, plus 1e-4; bf16: the larger of 2%, phase 3's rule for the
Functions' gradients, and 4x that floor), ms of forward + backward. 18c:
unet_resnet50 binary Lovasz resident bf16 steps (phase 11's set-up) with
JAX's ``variant="tree"`` (the port's Adam) and ``"flat"`` (``FlatAdam``)
from one state: with cuDNN deterministic, one step each, the loss
bit-equal; FlatAdam from the initial state on the tree run's first
gradients, every parameter within 4 f32 ulps of the tree step's (ulps of
the largest of its value before, after and the update); a grad-off eval
after the flat step sees it as a fresh model does (phase 5's rule); then
chunks of 8 steps (cuDNN as configured), the variants alternating tree,
flat, flat, tree, ms/step, launches 5 + 5 + 6 + 6 per step, and the
optimizer's own ms per call: busy (kernel time in a profiler window),
stream (CUDA events, launch gaps included) and host; and a 1x2 space-axis
f32 step with ``flat`` on two gloo ranks on the one card, held to 12b's
rule as 16b holds its SGD step.

The model phases (5, 6, 8, 9, 10) record each model's ``square_conv_paths`` in
the dtype they run, and fail if a square conv site would take the CUDA-core
kernel: in f32 every site is ``tf32x3_c64`` (C <= 64) or ``tf32x3``.

Last, the ``kernels`` JSON line (unet_resnet50's entries, then the
families' under names of their own, then the f32 conv's, ``[f32]``, with
phase 9's launches (the grad-mode pack kernel ``conv3x3_pack_tf32x3`` among
them, ``library_ms`` null: no PyTorch call computes it), then the f32
entries at unet_resnet50's sites, ``[...,f32]``, with phase 10b's
multitask launches, then phase 16's halo
and band entries, ``[...,halo]`` and ``[band...]``, with 16b's launches,
then phase 17's, ``[align_corners=False,band...]`` and ``[...,halo...]``,
with 17b's launches of the three families),
the card line, and the result line.

Imports nothing of JAX, PIL or cv2. Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
# f32-accurate work on the tensor cores: 3xTF32 is three TF32 products per
# f32 product, at the 495 TFLOP/s dense TF32 rate. The conv's ``tf32x3``
# rows are bound against it (the least time the card takes for f32-accurate
# work); ``cuda_core_bound_ms`` keeps the 67 TFLOP/s one beside it.
PEAK_FLOPS_3XTF32 = 495e12 / 3
# unet_resnet50's six fused sites in f32: C = 512, 256, 128, and 64 three times.
F32_FUSED_PATHS = {"tf32x3": 3, "tf32x3_c64": 3}
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
           "conv3x3_dgrad": 1e-4, "conv3x3_pack_tf32x3": 0.0}  # the pack: bit for bit
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
# The CUDA-core conv kernel where no tensor-core path takes the call (C % 4
# in f32, C % 16 in bf16): (C, label, dtype), at 60^2, phase 7.
FMA_CASES = [(130, "f32", torch.float32), (130, "bf16", torch.bfloat16)]
# Kernel launches per forward (predict) and per train step, by family.
FAMILY_FORWARD_LAUNCHES = {
    "unet_plain": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 9},
    "attention_unet": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 9},
    "dualdense_unet": {"upsample2x": 4, "conv3x3_bias_relu": 0, "conv3x3_same": 0},
}
ZERO_GRADIENT_PARAMS = ("attn.psi.0.bias",)  # phase 8: finite, 0 by construction
FAMILY_TRAIN_STEPS = 20  # BCE falls within a few steps: mean of the last ten below the first ten
FAMILY_F32_STEPS = 3  # phase 9: unet_plain in f32 at full width, timed only
# Phases 10a-10d: multitask_unet and the multiclass task. multitask_unet's
# decoder is unet_resnet50's, so its kernel sites are too; multiclass runs
# K = --num-classes 4 + 1 = 5 output classes (the train CLI's default).
TASK_TRAIN_STEPS = 20  # 10a, 10c: the loss falls (mean of the last ten below the first ten)
TASK_F32_STEPS = 3  # 10b: the paper pipeline's --no-amp, timed only
MC_CLASSES = 5
RESNET_PER_STEP = {"upsample2x": 5, "upsample2x_backward": 5, "conv3x3_bias_relu": 6,
                   "conv3x3_same": 0, "conv3x3_dgrad": 6}
# f32 site rows of the align_corners=True upsample and the fused conv, at the
# train shapes (512^2, batch 8): (site, C, H_in of the upsample / H of the
# conv, count per step); the upsample backward reads its cat slice as in phase 3.
F32_UPSAMPLE_SITES = [("up_concat4.up", 2048, 16, 1), ("up_concat3.up", 512, 32, 1),
                      ("up_concat2.up", 256, 64, 1), ("up_concat1.up", 128, 128, 1),
                      ("up_conv.0", 64, 256, 1)]
F32_FUSED_SITES = [("up_concat4.conv2", 512, 32, 1), ("up_concat3.conv2", 256, 64, 1),
                   ("up_concat2.conv2", 128, 128, 1), ("up_concat1.conv2", 64, 256, 1),
                   ("up_conv.1, up_conv.3", 64, 512, 2)]
# Phase 11, the device-resident path: a split of 64 canvases at 512^2, chunks
# of 8 steps (the train CLI's --scan-chunk). 11a: images of the card's
# augmentation against the CPU's within 1e-5 (f32 both sides; the sums
# differ by an FMA's rounding, the HSV round trip magnifies it ~10x); a mask
# pixel may differ only within 1e-4 of a .5 rounding boundary, and such
# pixels stay under 1e-4 of the pixels. 11b: augmentation off, the chunk's
# losses against the host-fed loop's within rtol 1e-3 (bf16 both; the same
# inputs, cuDNN's wgrad need not sum alike twice).
RESIDENT_CANVASES, RESIDENT_CHUNK = 64, 8
TOL_AUG_IMAGE, AUG_BOUNDARY, AUG_MAX_BOUNDARY_SHARE = 1e-5, 1e-4, 1e-4
TOL_RESIDENT_LOSS, RESIDENT_COMPARED_STEPS, HOST_FED_STEPS = 1e-3, 3, 8
# Phase 12, data parallelism. 12a: the synchronised BN against cuDNN's at
# ResNet-50's layer1 bn3 shape at 512^2, batch 8. f32: both sum in f32 in
# other orders (sum and sum of squares, against cuDNN's Welford), 1e-4 of the
# largest value; bf16: output and input gradient are bf16 in both, so one
# bf16 ulp apart at most (as TOL_BF16), the rest f32. 12b: the first step's
# loss to 1e-5 (f32, same weights), updates to phase 6's rule; the bf16
# chunk's first loss to 11b's rtol 1e-3, and every loss to the larger of
# that and twice the rounding floor of 12c (two 1-process chunks apart only
# in BN's rounding: bf16 outputs one ulp apart, which Adam's sign-like
# updates carry on; measured 7.5e-4, over 1e-3 in the 2-rank chunk's
# sixth step). 12c: the first bf16 step's loss to 1e-3.
BN_SHAPE = (8, 256, 128, 128)
TOL_SYNC_BN = {"f32": 1e-4, "bf16": 2.0 ** -7}
TOL_DDP_LOSS_F32, TOL_DDP_LOSS_BF16, DDP_LR_SGD = 1e-5, 1e-3, 1e-2
DDP_BF16_FLOOR_FACTOR = 2.0
CLI_TIMEOUT_S = 300  # 12d's CLI run: a few steps at 512^2 take ~1 min
DDP_RANKS = 2
# Phase 13. 13a: one site shape per operator (batch 8; 480^2 forward, 512^2
# backward sites): up_concat3.up, its cat slice, up_concat2.conv2, and
# unet_plain's down2 conv2 for the bias-free conv. 13b/13c: the artifact
# against eager predict to export_serving's --check rule; 13d: the CLI's
# profiled window.
OPCHECK_SHAPES = {"upsample2x": (512, 30), "upsample2x_backward": (512, 32, 512),
                  "conv3x3_bias_relu": (128, 120), "conv3x3_same": (256, 120),
                  "conv3x3_dgrad": (128, 128)}
SERVING_BATCHES = {"bf16": (1, BATCH), "f32": (1,)}
SERVING_CALLS = 20
PROFILE_CHUNK, PROFILE_TRAIN_BATCHES = 2, 4
DISPATCH_CALLS = 500
# Phase 14: the paper pipeline's legs (task, --max-stage) on synthetic:16
# at 512^2, batch 8, one epoch of two steps; each fit's train forwards.
PIPELINE_LEGS = (("binary", 4), ("multiclass", 1), ("multitask", 4))
PIPELINE_FLAGS = ["--data-path", "synthetic:16", "--epochs", "1", "--max-batches", "2",
                  "--input-size", str(TRAIN_SIZE), "--batch-size", str(BATCH)]
PIPELINE_STEPS = 2
# Phase 15: one seed of the accuracy study's bf16 unet_resnet50 + Lovasz arm.
STUDY_ARM, STUDY_EPOCHS = "resnet_lovasz/bf16", 2
# How kernel and library ``ms`` are timed: calls captured into a CUDA graph
# and replayed, so the host's dispatch (as long as the smallest sites' card
# time) stays out; the eager time sits beside it as ``eager_ms``.
MS_METHOD = "cuda_graph_replay"
# The timing budget of a dgrad row's comparisons (the flipped composition,
# its pack, the grad-mode pack): shorter than a row's own, to keep the run's length.
EXTRA_BUDGET_MS = 60.0


def bound(nbytes: float, flops: float, dtype, path: str = "") -> tuple[float, str]:
    from unet_embroidery_seg_torch.ops.conv3x3 import TF32X3_PATHS

    peak = PEAK_FLOPS_3XTF32 if path in TF32X3_PATHS else PEAK_FLOPS[dtype]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_site(prefix: str, kernel: str, site: str, path: str, dtype, run, plain, library,
                 nbytes: float, flops: float, shapes: dict, fma=None, flipped=None) -> dict:
    """Hold ``run`` against ``plain`` and time it, ``plain`` and ``library``: one site row.

    ``library`` None: no PyTorch call computes the function (``library_ms``
    null). ``fma`` (the conv's f32 rows on ``tf32x3``): the CUDA-core kernel
    on the same call, timed beside it as ``fma_ms``. ``flipped`` (dgrad
    rows, ``_flipped_dgrad``): dgrad as composed before it read the
    forward's packing, which must give ``run``'s result bit for bit, timed
    beside it (``flipped_ms``) with its pack alone (``flipped_pack_ms``) and
    the forward's grad-mode pack that ``run`` reads (``grad_pack_ms``), where
    ``count`` > 0. Prints the row after ``prefix``, then raises if the error
    is over the tolerance or the composition differs.
    """
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    got = run()
    torch.cuda.synchronize()
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    tol = (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32[kernel]) * want.float().abs().max().item()
    equal_to_flipped = None if flipped is None else torch.equal(got, flipped["run"]())
    del got, want
    bound_ms, bound_by = bound(nbytes, flops, dtype, path)
    eager_ms = event_ms(run)
    library_eager_ms = None if library is None else event_ms(library)
    ms = graph_ms(run, eager_ms)
    row = {
        "kernel": kernel, "site": site, "path": path, **shapes, "dtype": str(dtype),
        "max_abs_err": err, "tol": tol,
        "ms_method": MS_METHOD, "ms": ms, "eager_ms": eager_ms, "plain_ms": event_ms(plain),
        "library_ms": None if library is None else graph_ms(library, library_eager_ms),
        "library_eager_ms": library_eager_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
        "tflops": flops / ms / 1e9,
    }
    if path == "wgmma":  # the bf16 streamed layout: its clusters and the weights they read from L2
        from unet_embroidery_seg_torch.ops.conv3x3 import streamed_schedule

        n, c, h, w = shapes["shape"]
        sched = streamed_schedule(n, h, w, c, tuple(shapes.get("pad", (1, 1))))
        row.update({"cluster": sched["cluster"], "l2_weight_bytes": sched["l2_weight_bytes"],
                    "l2_weight_bytes_per_s": sched["l2_weight_bytes"] / ms * 1e3})
    if path == "c64_persistent":  # the bf16 C <= 64 kernel: its tile, items and halo pitch
        from unet_embroidery_seg_torch.ops.conv3x3 import c64_schedule

        n, c, h, w = shapes["shape"]
        sched = c64_schedule(n, h, w, tuple(shapes.get("pad", (1, 1))))
        row.update({"tile": list(sched["tile"]), "items": sched["items"],
                    "items_per_cta": sched["items_per_cta"], "halo_pitch": sched["halo_pitch"],
                    "dropped_share": sched["dropped_share"]})
    if fma is not None:
        row["fma_ms"] = graph_ms(fma, event_ms(fma))
        row["cuda_core_bound_ms"] = bound(nbytes, flops, dtype, "fma")[0]
    if flipped is not None:
        row["equal_to_flipped"] = equal_to_flipped
        if shapes.get("count", 1) > 0:
            for name, key in (("flipped_ms", "run"), ("flipped_pack_ms", "pack"),
                              ("grad_pack_ms", "grad_pack")):
                fn = flipped[key]
                row[name] = graph_ms(fn, event_ms(fn, EXTRA_BUDGET_MS), EXTRA_BUDGET_MS)
    print(f"{prefix} " + json.dumps(row), flush=True)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{kernel} at {site}: max abs err {err} > tol {tol}")
    if equal_to_flipped is False:
        raise AssertionError(f"{kernel} at {site}: differs from the flipped-packing composition")
    return row


def _flipped_dgrad(g, w, pad, packed) -> dict:
    """dgrad as composed before it read the forward's packing, for a dgrad row.

    ``run``: the forward kernel on the weights flipped in space, transposed
    in channels and packed for the call; ``pack``: that pack alone;
    ``grad_pack``: the forward's grad-mode packing (``pack_conv3x3_grad``),
    which the new dgrad reads instead (``packed``, of the same weights).
    """
    from unet_embroidery_seg_torch.ops import conv3x3 as C

    def pack():
        return C.pack_conv3x3_weight(C._dgrad_weight(w), g.dtype)

    return {"run": lambda: C._launch(g, pack(), None, "flipped dgrad", pad=tuple(pad)),
            "pack": pack, "grad_pack": lambda: C.pack_conv3x3_grad(w, g.dtype)}


def _fma_call(x, w, bias=None, dgrad: bool = False):
    """The CUDA-core (``fma``) kernel on the call ``x``'s f32 ``tf32x3`` site makes.

    Weights packed once in the ``fma`` layout; dgrad reads them flipped and
    transposed in the kernel, as ``conv3x3_dgrad`` does on that path.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import _launch, pack_conv3x3_weight

    packed = pack_conv3x3_weight(w, x.dtype, "fma")
    if dgrad:
        return lambda: _launch(x, packed, None, "fma dgrad", "fma", dgrad=True)
    return lambda: _launch(x, packed, bias, "fma", "fma")


def _forward_case(kernel: str, c: int, h: int, dtype, gen: torch.Generator,
                  align_corners: bool = True, epilogue: bool = True):
    """(run, plain, library, nbytes, flops, path, x, fma) of one forward site, batch 8.

    upsample2x: a random input, the upsample in ``align_corners``.
    conv3x3_same: with ``epilogue`` the fused relu(conv + bias) on a ReLU
    output (unet_resnet50's decoder); without, the bias-free conv alone
    (a DoubleConv's conv2) on a signed input, its output (BN's input)
    signed too. Weights fan-in scaled, float32 as the model holds them.
    ``fma`` is the CUDA-core kernel on the same call where the path is
    ``tf32x3``, else None.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        TF32X3_PATHS,
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
        return run, plain, library, nbytes, flops, "staged", x, None
    x = (torch.relu(x) if epilogue else x).contiguous(memory_format=cl)
    w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
    nbytes = 2 * x.numel() * es + 9 * c * c * es
    flops = 2.0 * 9 * c * c * BATCH * h * h
    path, b = conv3x3_path(c, dtype), None
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
    fma = _fma_call(x, w, b) if path in TF32X3_PATHS else None
    return run, plain, library, nbytes, flops, path, x, fma


@torch.no_grad()
def check_sites(gen: torch.Generator) -> list[dict]:
    """Phase 2: unet_resnet50's 11 forward sites at 480^2 (align_corners=True, fused epilogue).

    Plus one f32 case per kernel (the conv's on ``tf32x3``, ``fma`` beside it).
    """
    cases = [("upsample2x", f"up{c}x{h}", c, h, torch.bfloat16) for c, h in UPSAMPLE_SITES]
    cases.append(("upsample2x", "up64x240.f32", 64, 240, torch.float32))
    cases += [("conv3x3_same", n, c, h, torch.bfloat16) for n, c, h in CONV_SITES]
    cases.append(("conv3x3_same", "up_concat2.conv2.f32", 128, 120, torch.float32))
    rows = []
    for kernel, site, c, h, dtype in cases:
        run, plain, library, nbytes, flops, path, x, fma = _forward_case(kernel, c, h, dtype, gen)
        rows.append(measure_site("site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops, {"shape": list(x.shape), "count": 1,
                                                 "sites_of": "unet_resnet50"}, fma))
    return rows


@torch.no_grad()
def check_family_sites(gen: torch.Generator) -> list[dict]:
    """Phase 7: the families' forward sites at 480^2, align_corners=False, no epilogue.

    The bias-free conv at its 5 distinct DoubleConv shapes (9 sites, C = 64
    to 1024) in bf16 and in f32 (``tf32x3``, the ``fma`` kernel timed beside
    it: ``--no-amp``), the upsample at its 4 sites in bf16 plus one f32
    case, and the CUDA-core kernel at C = 130 (no tensor-core path takes it)
    in both types, held but no model site (``count`` 0). ``count`` is the
    number of sites of that shape in one forward.
    """
    cases = [("upsample2x", n, c, h, 1, torch.bfloat16) for n, c, h in FAMILY_UPSAMPLE_SITES]
    cases.append(("upsample2x", "up4.up.f32", 128, 240, 1, torch.float32))
    cases += [("conv3x3_same", n, c, h, k, torch.bfloat16) for n, c, h, k in SAME_SITES]
    cases += [("conv3x3_same", f"{n}.f32", c, h, k, torch.float32) for n, c, h, k in SAME_SITES]
    cases += [("conv3x3_same", f"fma.c{c}.{t}", c, 60, 0, dtype) for c, t, dtype in FMA_CASES]
    rows = []
    for kernel, site, c, h, count, dtype in cases:
        run, plain, library, nbytes, flops, path, x, fma = _forward_case(
            kernel, c, h, dtype, gen, align_corners=False, epilogue=False)
        rows.append(measure_site("family_site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops, {"shape": list(x.shape), "count": count,
                                                 "sites_of": "families", "align_corners": False,
                                                 "epilogue": False}, fma))
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
    """(run, plain, library, nbytes, flops, path, g, fma, flipped) of one backward site, batch 8.

    upsample2x_backward: the gradient of an upsample of (C, H, H), channels
    [skip:] of the ``torch.cat`` gradient when ``skip`` (read in place).
    conv3x3_dgrad: a signed (C, H, H) gradient; the kernel reads the
    forward's grad-mode packing, made once (its time is the kernel's
    alone); ``flipped`` the composition that packed flipped weights per
    call, for ``measure_site``; ``fma`` the CUDA-core kernel beside an f32
    ``tf32x3`` site.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        SAME,
        TF32X3_PATHS,
        conv3x3_dgrad,
        conv3x3_dgrad_plain,
        conv3x3_path,
        pack_conv3x3_grad,
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
        path = "staged, cat slice" if skip else "staged"
        return run, plain, library, nbytes, flops, path, g, None, None
    g = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype).contiguous(memory_format=cl)
    es = g.element_size()
    w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
    # channels_last, as the model's convs hold their weights, so the
    # yardstick gets the layouts the model's own backward gives cuDNN
    w = w.contiguous(memory_format=cl)
    wd = w.to(dtype)
    packed = pack_conv3x3_grad(w, dtype)  # the forward's, with grad on
    run = lambda: conv3x3_dgrad(g, w, SAME, packed)  # noqa: E731
    plain = lambda: conv3x3_dgrad_plain(g, w)  # noqa: E731
    library = lambda: torch.nn.grad.conv2d_input(g.shape, wd, g, padding=1)  # noqa: E731
    nbytes = 2 * g.numel() * es + 9 * c * c * es
    flops = 2.0 * 9 * c * c * BATCH * h * h
    path = conv3x3_path(c, dtype)
    fma = _fma_call(g, w, dgrad=True) if path in TF32X3_PATHS else None
    return run, plain, library, nbytes, flops, path, g, fma, _flipped_dgrad(g, w, SAME, packed)


def check_backward_sites(gen: torch.Generator) -> list[dict]:
    """Phase 3: unet_resnet50's 11 backward sites at 512^2 (align_corners=True)."""
    cases = [("upsample2x_backward", n, c, h, skip, torch.bfloat16)
             for n, c, h, skip in UPSAMPLE_BWD_SITES]
    cases.append(("upsample2x_backward", "up_conv.0.f32", 64, 256, 0, torch.float32))
    cases += [("conv3x3_dgrad", n, c, h, 0, torch.bfloat16) for n, c, h in DGRAD_SITES]
    cases.append(("conv3x3_dgrad", "up_concat2.conv2.f32", 128, 128, 0, torch.float32))
    rows = []
    for kernel, site, c, h, skip, dtype in cases:
        run, plain, library, nbytes, flops, path, g, fma, flipped = _backward_case(
            kernel, c, h, skip, dtype, gen)
        rows.append(measure_site("backward_site", kernel, site, path, dtype, run, plain, library,
                                 nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape),
                                  "count": 1, "sites_of": "unet_resnet50"}, fma, flipped))
    return rows


def check_family_backward_sites(gen: torch.Generator) -> list[dict]:
    """Phase 7: the families' backward sites at 512^2, align_corners=False.

    The upsample backward at its 4 sites, each reading its channel slice of
    the cat gradient (skip widths 512, 256, 128, 64), bf16 plus one f32
    case, and dgrad at the 5 DoubleConv shapes (9 sites) in bf16 and in f32
    (``tf32x3``, ``fma`` beside it), and the ``tf32x3`` grad-mode pack kernel
    (``_pack_rows``) at the 5 shapes, whose dgrad planes the f32 rows read.
    """
    cases = [("upsample2x_backward", n, c, h, skip, 1, torch.bfloat16)
             for n, c, h, skip in FAMILY_UPSAMPLE_BWD_SITES]
    cases.append(("upsample2x_backward", "up4.up.f32", 128, 256, 64, 1, torch.float32))
    cases += [("conv3x3_dgrad", n, c, h, 0, k, torch.bfloat16) for n, c, h, k in FAMILY_DGRAD_SITES]
    cases += [("conv3x3_dgrad", f"{n}.f32", c, h, 0, k, torch.float32)
              for n, c, h, k in FAMILY_DGRAD_SITES]
    rows = _pack_rows("family_backward_site", FAMILY_DGRAD_SITES, gen, "families")
    for kernel, site, c, h, skip, count, dtype in cases:
        run, plain, library, nbytes, flops, path, g, fma, flipped = _backward_case(
            kernel, c, h, skip, dtype, gen, align_corners=False)
        rows.append(measure_site("family_backward_site", kernel, site, path, dtype, run, plain,
                                 library, nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape),
                                  "count": count, "sites_of": "families",
                                  "align_corners": False}, fma, flipped))
    return rows


def function_check(gen: torch.Generator) -> dict:
    """The autograd Functions' gradients on the card against the plain versions' autograd.

    conv3x3 at up_concat2.conv2 (128 channels, 128^2) and upsample2x at
    up_concat2.up (256 channels, 64^2 -> 128^2, its output concatenated
    after a skip as in the decoder), batch 8, bf16 activations, float32
    parameters.

    The conv's reference is the plain version's pre-activation (f32 sums,
    the bf16-valued weights and bias) differentiated under the ReLU mask of
    the kernel's output, which the Function's backward uses: where a
    pre-activation is within f32 summation noise of 0 the two sums may take
    opposite signs, and one such pixel moves dx by a whole |g| * |W| column
    (0.125 at seed 5 once the bias was read as bf16). Those pixels are
    counted and held to lie within TOL_F32 (f32 summation noise, 1e-4 of
    the largest pre-activation) of 0 (``relu_mask_flips``), so a wrong
    mask still fails.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import _conv3x3_f32, conv3x3_bias_relu
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

    dev, cl = torch.device("cuda"), torch.channels_last
    x = torch.relu(torch.randn(BATCH, 128, 128, 128, generator=gen)).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=cl).requires_grad_()
    w = (torch.randn(128, 128, 3, 3, generator=gen) / (3 * 128 ** 0.5)).to(dev).requires_grad_()
    b = (0.1 * torch.randn(128, generator=gen)).to(dev).requires_grad_()
    g = torch.randn(BATCH, 128, 128, 128, generator=gen).to(dev, torch.bfloat16)
    y = conv3x3_bias_relu(x, w, b)
    got = torch.autograd.grad(y, (x, w, b), g)
    z = _conv3x3_f32(x, w) + b.to(torch.bfloat16).float()[None, :, None, None]
    mask = y.detach() > 0
    want = torch.autograd.grad(z, (x, w, b), g.float() * mask)
    flips = (z.detach() > 0) != mask
    flip_z = z.detach().abs()[flips].max().item() if flips.any() else 0.0
    result = {"relu_mask_flips": {"pixels": int(flips.sum()), "max_abs_preactivation": flip_z,
                                  "max_abs_err": flip_z,
                                  "tol": TOL_F32["conv3x3_same"] * z.detach().abs().max().item()}}
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


def square_conv_paths(model, dtype) -> dict:
    """{kernel path: square conv sites of ``model``} for calls in ``dtype``.

    Every site must take a tensor-core path (bf16 ``c64_persistent`` /
    ``wgmma``, f32 ``tf32x3_c64`` / ``tf32x3``): a model site on the CUDA cores (``fma``)
    fails the run.
    """
    from unet_embroidery_seg_torch.models.blocks import Conv3x3Same, SquareConv3x3
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_path

    paths: dict[str, int] = {}
    for m in model.modules():
        if isinstance(m, (SquareConv3x3, Conv3x3Same)):
            path = conv3x3_path(m.weight.shape[0], dtype)
            paths[path] = paths.get(path, 0) + 1
    if "fma" in paths:
        raise AssertionError(f"square conv sites on the CUDA cores in {dtype}: {paths}")
    return paths


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
              "max_softmax_diff": softmax_err,
              "square_conv_paths": square_conv_paths(card_model, torch.float32)}
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
        "square_conv_paths": square_conv_paths(model, torch.bfloat16 if amp else torch.float32),
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
        if dev == "cuda":
            paths = square_conv_paths(model, torch.float32)
    exact = name != "unet_resnet50"
    if exact:
        loss["cpu_f64"], grads["cpu_f64"] = _f64_train_grads(name, state, images, pngs, sm)

    def rel(run: str, ref: str = "cpu") -> dict:
        return {n: ((g - grads[ref][n]).norm() / grads[ref][n].norm().clamp_min(1e-30)).item()
                for n, g in grads[run].items()}

    card, up, down = rel("card"), rel("cpu_up"), rel("cpu_down")
    noise = {n: max(up[n], down[n]) for n in card}
    result, live = {"model": name, "square_conv_paths": paths}, list(card)
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


def dgrad_graph_check(gen: torch.Generator) -> dict:
    """3c: a captured bf16 forward + backward sees weights changed in place before a replay.

    With grad on the forward packs the weights each call and dgrad reads
    that packing, so a CUDA graph of a train stage repacks at every replay.
    Two stages at their 512^2 train shapes, batch 8, bf16 autocast (cast
    cache off): unet_resnet50's ``up_concat2`` (upsample, concat, stock
    conv, the fused conv) and unet_plain's ``down1`` ``DoubleConv`` (the
    bias-free conv, BN). Each stage's forward and dx are captured after a
    warm-up on a side stream, replayed, then every parameter is changed in
    place under ``no_grad`` (each value scaled by its own factor in [0.5,
    1.5): a sign flip alone leaves a BN stage's dx as it was) and the graph
    replayed again: dx must equal an eager call's on the new weights (bf16
    tolerance; the same kernels) and differ from the first replay's.
    """
    from unet_embroidery_seg_torch.models import blocks
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_dgrad

    dev, cl = torch.device("cuda"), torch.channels_last
    stages = {
        "up_concat2": (blocks.UnetUpNoBN(256 + 256, 128),
                       ((BATCH, 256, 128, 128), (BATCH, 256, 64, 64)), (BATCH, 128, 128, 128)),
        "down1 DoubleConv": (blocks.DoubleConv(64, 128), ((BATCH, 64, 256, 256),),
                             (BATCH, 128, 256, 256)),
    }
    result = {}
    for name, (stage, in_shapes, out_shape) in stages.items():
        stage = blocks.init_weights(stage, gen).to(dev, memory_format=cl)
        inputs = [torch.randn(sh, generator=gen).to(dev).contiguous(memory_format=cl)
                  for sh in in_shapes]
        x = inputs[-1].requires_grad_()
        gy = torch.randn(out_shape, generator=gen).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)

        def step(stage=stage, inputs=inputs, x=x, gy=gy):
            with torch.autocast("cuda", torch.bfloat16, cache_enabled=False):
                y = stage(*inputs)
            return torch.autograd.grad(y, (x,), gy)[0]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        before = conv3x3_dgrad.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            dx_static = step()
        captured = conv3x3_dgrad.launches - before
        graph.replay()
        first = dx_static.clone()
        with torch.no_grad():
            for p in stage.parameters():
                p.mul_(0.5 + torch.rand(p.shape, generator=gen).to(dev))
        graph.replay()
        second = dx_static.clone()
        eager = step()
        torch.cuda.synchronize()
        scale = eager.float().abs().max().item()
        row = {"dgrad_launches_captured": captured,
               "replay_vs_eager_max_abs_diff": (second.float() - eager.float()).abs().max().item(),
               "replay_equal_to_eager": torch.equal(second, eager),
               "changed_by": (second.float() - first.float()).abs().max().item(),
               "tol": TOL_BF16 * scale}
        result[name] = row
        del graph, dx_static, first, second, eager, inputs, x, gy, stage
        if not (captured == 1 and row["changed_by"] > 0
                and row["replay_vs_eager_max_abs_diff"] <= row["tol"]):
            raise AssertionError(f"captured {name} after an in-place weight change: {row}")
    torch.cuda.empty_cache()
    print("dgrad_graph " + json.dumps(result), flush=True)
    return result


def _packs_in_step(name: str, amp: bool) -> dict:
    """Weight packs made in one forward and in its backward, grad on, of ``name``.

    64^2, batch 2 (the count does not depend on the size), bf16 autocast or
    f32. Counts ``pack_conv3x3_grad`` calls and ``pack_conv3x3_weight``
    calls made outside it; the backward must make none.
    """
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import conv3x3 as C

    model = build_model(name, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).cuda()
    x = x.contiguous(memory_format=torch.channels_last)
    counts, phase, inside = {"forward": 0, "backward": 0}, ["forward"], [False]
    pack_grad, pack_weight = C.pack_conv3x3_grad, C.pack_conv3x3_weight

    def grad_spy(*args):
        counts[phase[0]] += 1
        inside[0] = True
        try:
            return pack_grad(*args)
        finally:
            inside[0] = False

    def weight_spy(*args, **kwargs):
        counts[phase[0]] += 0 if inside[0] else 1
        return pack_weight(*args, **kwargs)

    grad_spy.launches = pack_grad.launches  # the kernel's wrapper counts on the module global
    C.pack_conv3x3_grad, C.pack_conv3x3_weight = grad_spy, weight_spy
    try:
        with torch.autocast("cuda", torch.bfloat16, enabled=amp):
            out = model(x)
        phase[0] = "backward"
        (out if isinstance(out, torch.Tensor) else out[0]).float().sum().backward()
        torch.cuda.synchronize()
    finally:
        C.pack_conv3x3_grad, C.pack_conv3x3_weight = pack_grad, pack_weight
        pack_grad.launches = grad_spy.launches
    return counts


def packing_cost() -> dict:
    """The weight packs of a train step, counted, and their card and host cost.

    With grad on each square conv site packs its weight once, in its
    forward (``pack_conv3x3_grad``), and its backward's dgrad reads that
    packing: ``packs_per_step`` counts, on one forward + backward of
    unet_plain (9 DoubleConv sites) and unet_resnet50 (6 fused sites) in
    bf16 and f32, the packs of each half; the backward's must be 0. Then,
    per type, at the families' 9 sites (float32 OIHW in, channels_last as
    the models hold it): ``card_ms`` by graph replay of the step's 9 packs
    and ``host_ms_median`` the host's time to launch them, beside
    the same for the 18 packs of the composition that packed each weight
    again, flipped, for dgrad (``flipped_*``).
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        _dgrad_weight,
        pack_conv3x3_grad,
        pack_conv3x3_weight,
    )
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    counts = {name: {("bf16" if amp else "f32"): _packs_in_step(name, amp) for amp in (True, False)}
              for name in ("unet_plain", "unet_resnet50")}
    torch.cuda.empty_cache()
    sites = {"unet_plain": 9, "unet_resnet50": 6}
    gen = torch.Generator().manual_seed(6)
    weights = [torch.randn(c, c, 3, 3, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last) for _, c, _, k in SAME_SITES for _ in range(k)]
    result = {"sites": sites, "packs_per_step": counts,
              "flipped_packs_per_step": {k: 2 * v for k, v in sites.items()}}

    def host_ms(fn):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    for dtype in (torch.bfloat16, torch.float32):

        def pack_step(dtype=dtype):
            return [pack_conv3x3_grad(w, dtype) for w in weights]

        def flipped_step(dtype=dtype):
            return [pack_conv3x3_weight(v, dtype) for w in weights for v in (w, _dgrad_weight(w))]

        entry = {}
        for key, fn in (("", pack_step), ("flipped_", flipped_step)):
            written = sum(t.nbytes for t in fn())
            eager = event_ms(fn)
            entry.update({f"{key}bytes_written_per_step": written,
                          f"{key}card_ms": graph_ms(fn, eager), f"{key}eager_ms": eager,
                          f"{key}host_ms_median": host_ms(fn)})
        result[str(dtype)] = entry
        torch.cuda.empty_cache()
    print("packing_cost " + json.dumps(result), flush=True)
    for name, by_type in counts.items():
        if any(c != {"forward": sites[name], "backward": 0} for c in by_type.values()):
            raise AssertionError(f"{name}: packs per step {by_type}, want {sites[name]} in the "
                                 f"forward and none in the backward")
    return result


def _pack_rows(prefix: str, sites, gen: torch.Generator, sites_of: str) -> list[dict]:
    """The ``tf32x3`` grad-mode pack kernel at f32 conv sites: (site, C, ..., count) rows.

    Held bit for bit (tolerance 0) against its plain version, the two
    ``pack_conv3x3_weight`` packings stacked; no PyTorch call computes it.
    Bound by bytes: the f32 weight read once, the four planes written once.
    """
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        _dgrad_weight,
        pack_conv3x3_grad,
        pack_conv3x3_weight,
    )

    rows = []
    for site, c, _, count in sites:
        w = torch.randn(c, c, 3, 3, generator=gen).cuda().contiguous(
            memory_format=torch.channels_last)
        out = pack_conv3x3_grad(w, torch.float32)
        nbytes = w.nbytes + out.nbytes
        rows.append(measure_site(
            prefix, "conv3x3_pack_tf32x3", f"{site}.f32", "tf32x3", torch.float32,
            lambda w=w: pack_conv3x3_grad(w, torch.float32),
            lambda w=w: torch.stack([pack_conv3x3_weight(v, torch.float32)
                                     for v in (w, _dgrad_weight(w))]),
            None, nbytes, 0.0, {"shape": list(out.shape), "count": count, "sites_of": sites_of}))
        del w, out
    return rows


def check_f32_resnet_sites(gen: torch.Generator) -> list[dict]:
    """Phase 10: unet_resnet50's (and multitask_unet's) kernel sites in f32 at the train shapes.

    512^2, batch 8, TF32 off for the library calls: the align_corners=True
    upsample forward at its 5 sites and its backward at the same 5 (cat
    slices), the fused conv (bias + ReLU, ``tf32x3``, ``fma`` beside it) at
    its 6 sites and their dgrad, and the grad-mode pack kernel at those
    sites, each against its plain version.
    """
    rows = []
    for kernel, sites in (("upsample2x", F32_UPSAMPLE_SITES), ("conv3x3_same", F32_FUSED_SITES)):
        for site, c, h, count in sites:
            run, plain, library, nbytes, flops, path, x, fma = _forward_case(
                kernel, c, h, torch.float32, gen)
            rows.append(measure_site("f32_site", kernel, f"{site}.f32", path, torch.float32, run,
                                     plain, library, nbytes, flops,
                                     {"shape": list(x.shape), "count": count,
                                      "sites_of": "unet_resnet50, multitask_unet"}, fma))
            del run, plain, library, x, fma
    skips = {n: skip for n, _, _, skip in UPSAMPLE_BWD_SITES}
    cases = [("upsample2x_backward", site, c, h, skips[site], count)
             for site, c, h, count in F32_UPSAMPLE_SITES]
    cases += [("conv3x3_dgrad", site, c, h, 0, count) for site, c, h, count in F32_FUSED_SITES]
    rows += _pack_rows("f32_backward_site", F32_FUSED_SITES, gen, "unet_resnet50, multitask_unet")
    for kernel, site, c, h, skip, count in cases:
        run, plain, library, nbytes, flops, path, g, fma, flipped = _backward_case(
            kernel, c, h, skip, torch.float32, gen)
        rows.append(measure_site("f32_backward_site", kernel, f"{site}.f32", path, torch.float32,
                                 run, plain, library, nbytes, flops,
                                 {"shape": [BATCH, c, h, h], "grad_shape": list(g.shape),
                                  "count": count, "sites_of": "unet_resnet50, multitask_unet"},
                                 fma, flipped))
        del run, plain, library, g, fma, flipped
    torch.cuda.empty_cache()
    return rows


def _task_model(task: str, name: str, device: str = "cuda"):
    """A full-width seeded model for ``task``: multitask_unet, or ``name`` with MC_CLASSES outputs."""
    from unet_embroidery_seg_torch.models import build_model

    gen = torch.Generator().manual_seed(0)
    if task == "multitask":
        return build_model("multitask_unet", 1, generator=gen, device=device)
    return build_model(name, MC_CLASSES, generator=gen, device=device)


def _task_step(task: str, model, loss: str, amp: bool):
    """The port's train step of ``task``: multitask (seg BCE unweighted, cls weight 1) or
    multiclass (CE or focal, plus Dice)."""
    from unet_embroidery_seg_torch.engine import steps
    from unet_embroidery_seg_torch.ops import schedules

    opt = schedules.make_train_optimizer(model.parameters(), TRAIN_LR)
    if task == "multitask":
        return steps.make_multitask_train_step(model, opt, loss, 1.0, None, amp=amp)
    return steps.make_multiclass_train_step(model, opt, MC_CLASSES, focal=loss == "focal",
                                            use_dice=True, amp=amp)


def task_train_path(counters, task: str, name: str, loss: str, steps: int, per_step: dict,
                    amp: bool = True, checks: bool = True) -> dict:
    """``steps`` train steps of a full-width ``task`` model at 512^2, batch 8, on one seeded batch.

    multitask: multitask_unet (``name``), a seeded batch with class labels,
    seg BCE unweighted (the task's default) + class CE, dropout on.
    multiclass: ``name`` with K = 5, discs of classes 1-4, ``loss`` (ce or
    focal) + Dice. Adam over float32 masters at the CLI's lr; bf16 autocast
    unless ``amp`` is off. Counters are zeroed just before the timed steps
    and read just after: each must be ``per_step`` times the steps. Then,
    with ``checks``: every parameter has a finite gradient that is nonzero
    somewhere, the total loss falls (mean of the last ten below the first
    ten), one eval step holds (multitask: inter <= pred sum, target sum <=
    union <= 8 * 512^2, the confusion sums to 8; multiclass: its four
    metrics in [0, 1]), and an eval forward after one more step equals a
    fresh model's. Without ``checks`` only finite losses and the counts are
    held.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_task_batch

    model = _task_model(task, name)
    step = _task_step(task, model, loss, amp)
    batch = seeded_task_batch(BATCH, TRAIN_SIZE, seed=0, task=task, num_classes=MC_CLASSES)
    torch.manual_seed(0)  # multitask's dropout draws

    def run() -> float:  # float() waits for the card
        out = step(*batch)
        return float(out[0][0] if task == "multitask" else out)

    losses = [run()]  # warm-up: cuDNN plans, kernel loads, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(run())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    label = f"{task} {name} {loss} {'bf16' if amp else 'f32'}"
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label}: train launches {launches} != expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    dtype = torch.bfloat16 if amp else torch.float32
    paths = square_conv_paths(model, dtype)
    if not amp and paths != F32_FUSED_PATHS:  # the f32 runs: the six fused sites
        raise AssertionError(f"{label}: fused conv sites not on {F32_FUSED_PATHS}: {paths}")
    result = {
        "task": task, "model": name, "steps": steps, "size": TRAIN_SIZE, "batch": BATCH,
        "loss": loss, "lr": TRAIN_LR, "amp": amp,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms, "losses": losses,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "params_with_grad": sum(1 for _ in model.parameters()), "peak_mem_gb": peak_gb,
        "square_conv_paths": paths,
    }
    if checks:
        result.update(_task_checks(task, name, model, step, batch, loss, losses, label))
    print("task_train_path " + json.dumps(result), flush=True)
    return result


def _task_checks(task, name, model, step, batch, loss, losses, label) -> dict:
    from unet_embroidery_seg_torch.engine import steps

    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    if no_grad:
        raise AssertionError(f"{label}: {len(no_grad)} parameters without a finite nonzero "
                             f"gradient: {no_grad[:5]}")
    if not np.mean(losses[-10:]) < np.mean(losses[:10]):
        raise AssertionError(f"{label}: the loss did not fall on a fixed batch: {losses}")

    pixels = BATCH * TRAIN_SIZE ** 2
    if task == "multitask":
        images, pngs, cls, sm = batch
        triple, counts, confusion = steps.make_multitask_eval_step(model, loss)(
            images, pngs, cls, sm)
        inter, union, psum, tsum = counts.tolist()
        ok = (inter <= min(psum, tsum) and max(psum, tsum) <= union <= pixels
              and int(confusion.sum()) == BATCH
              and all(np.isfinite(v.item()) for v in triple))
        evaluated = {"eval_loss": [v.item() for v in triple], "eval_seg_counts": counts.tolist(),
                     "eval_confusion": confusion.tolist()}
    else:
        eval_loss, m = steps.make_multiclass_eval_step(
            model, MC_CLASSES, focal=loss == "focal", use_dice=True)(*batch)
        values = {k: v.item() for k, v in m.items()}
        ok = np.isfinite(eval_loss.item()) and all(0.0 <= v <= 1.0 for v in values.values())
        evaluated = {"eval_loss": eval_loss.item(), "eval_metrics": values}
    if not ok:
        raise AssertionError(f"{label}: eval step out of range: {evaluated}")

    # An eval forward (grad off: packed weights from the cache) after one
    # more step must see the step: equal to a fresh model with the weights.
    x = torch.from_numpy(batch[0]).cuda().permute(0, 3, 1, 2)

    def forward(m):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = m.eval()(x)
        return torch.cat([o.float().flatten() for o in (out if task == "multitask" else (out,))])

    before = forward(model)
    step(*batch)
    after = forward(model)
    fresh = _task_model(task, name)
    fresh.load_state_dict(model.state_dict(), strict=True)
    changed = (after - before).abs().max().item()
    stale = (after - forward(fresh)).abs().max().item()
    if not (changed > 0 and stale <= 0.1 * changed):
        raise AssertionError(f"{label}: eval after a step: changed by {changed}, off a fresh "
                             f"model by {stale}")
    return {**evaluated, "eval_after_step": {"changed": changed, "off_fresh": stale}}


def f32_multitask_card_vs_cpu() -> dict:
    """Phase 10d: multitask_unet in f32 at 128^2, batch 2, dropout p = 0: the card against the CPU.

    Fan-in scaled conv weights (as phase 6's predict), so the logits are
    O(1). Four runs from one state, as phase 6's train step: the CPU, the
    CPU with the input moved by about one f32 ulp up and down, and the
    card. Each run: an eval forward (seg and cls logits, held to 1e-3 of
    their scale like phase 6's predict), then one train step (seg BCE, class
    CE). The loss triple and every gradient are held, as a share of their
    size, to 4x the larger of the two moves (the CPU's own noise floor) plus
    1e-4; the fused conv sites' gradients also to 1e-2.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_task_batch
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn

    gen = torch.Generator().manual_seed(3)
    cpu_model = _task_model("multitask", "multitask_unet", device="cpu")
    with torch.no_grad():
        for m in cpu_model.modules():
            if isinstance(getattr(m, "weight", None), torch.Tensor) and m.weight.dim() == 4:
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
    state = cpu_model.state_dict()
    images, pngs, cls, sm = seeded_task_batch(2, 128, seed=3, task="multitask")
    runs = {"cpu": ("cpu", images), "cpu_up": ("cpu", images * np.float32(1 + 2.0 ** -23)),
            "cpu_down": ("cpu", images * np.float32(1 - 2.0 ** -23)), "card": ("cuda", images)}
    logits, loss, grads = {}, {}, {}
    for run, (dev, imgs) in runs.items():
        model = _task_model("multitask", "multitask_unet", device=dev)
        model.load_state_dict(state, strict=True)
        model.cls_head[4].p = 0.0  # CUDA and CPU generators differ
        logits[run] = [o.cpu() for o in make_predict_fn(model, amp=False)(imgs)]
        triple, _ = _task_step("multitask", model, "bce", amp=False)(imgs, pngs, cls, sm)
        loss[run] = [v.item() for v in triple]
        grads[run] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        if dev == "cuda":
            paths = square_conv_paths(model, torch.float32)

    def rel(run: str) -> dict:
        return {n: ((g - grads["cpu"][n]).norm() / grads["cpu"][n].norm().clamp_min(1e-30)).item()
                for n, g in grads[run].items()}

    def loss_rel(run: str) -> list:
        return [abs(a - b) / abs(b) for a, b in zip(loss[run], loss["cpu"])]

    card, up, down = rel("card"), rel("cpu_up"), rel("cpu_down")
    noise = {n: max(up[n], down[n]) for n in card}
    loss_noise = [max(a, b) for a, b in zip(loss_rel("cpu_up"), loss_rel("cpu_down"))]
    worst = max(card, key=card.get)
    sites = [n for n in card
             if n.startswith("up_conv.") or (n.startswith("up_concat") and ".conv2." in n)]
    logit_err = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(logits["card"], logits["cpu"])]
    floor = lambda v: TOL_TRAIN_NOISE_FACTOR * v + TOL_F32_GRAD  # noqa: E731
    result = {"model": "multitask_unet", "square_conv_paths": paths,
              "logit_rel_err": {"seg": logit_err[0], "cls": logit_err[1]},
              "logit_scale": {"seg": logits["cpu"][0].abs().max().item(),
                              "cls": logits["cpu"][1].abs().max().item()},
              "loss_card": loss["card"], "loss_cpu": loss["cpu"],
              "loss_rel_diff": loss_rel("card"), "loss_rel_noise": loss_noise,
              "median_grad_rel_diff": statistics.median(card.values()),
              "median_grad_rel_noise": statistics.median(noise.values()),
              "worst_grad_rel_diff": card[worst], "worst_grad_param": worst,
              "worst_grad_rel_noise": max(noise.values()),
              "kernel_site_grad_rel_diff": {n: card[n] for n in sites}}
    print("f32_multitask_card_vs_cpu " + json.dumps(result), flush=True)
    if not (np.isfinite(list(card.values())).all()
            and max(logit_err) <= TOL_FORWARD_REL
            and all(d <= floor(v) for d, v in zip(result["loss_rel_diff"], loss_noise))
            and max(card[n] for n in sites) <= TOL_TRAIN_GRAD_SITES
            and result["median_grad_rel_diff"] <= floor(result["median_grad_rel_noise"])
            and card[worst] <= floor(result["worst_grad_rel_noise"])):
        raise AssertionError(f"f32 multitask card vs CPU disagree: {result}")
    return result


def resident_split():
    """(host canvases, the same resident on the card): phase 11's seeded split."""
    from unet_embroidery_seg_torch.data.synthetic import resident_canvases
    from unet_embroidery_seg_torch.engine import resident

    cache = resident_canvases(RESIDENT_CANVASES, TRAIN_SIZE, seed=11, cls_labels=True)
    return cache, resident.upload(cache, "cuda")


def resident_augment_check(cache, data) -> dict:
    """11a: the card's augmentation against the CPU's on the same parameters, and its time."""
    from unet_embroidery_seg_torch.engine import resident
    from unet_embroidery_seg_torch.ops import device_augment as da
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    hw = (TRAIN_SIZE, TRAIN_SIZE)
    params = da.sample_params(torch.Generator("cuda").manual_seed(0), BATCH)
    cpu_params = tuple(p.cpu() for p in params)
    cpu_args = [torch.from_numpy(a[:BATCH]) for a in (cache.images, cache.masks, cache.valid_wh)]
    card_img, card_mask = da.augment_batch(*(a.cuda() for a in cpu_args), params=params,
                                           out_hw=hw)
    cpu_img, cpu_mask = da.augment_batch(*cpu_args, params=cpu_params, out_hw=hw)
    img_err = (card_img.cpu() - cpu_img).abs().max().item()
    differ = card_mask.cpu() != cpu_mask
    yc, _, xc, _ = da.paste_coords(cpu_args[2], cpu_params, hw, hw)

    def near(c):  # within AUG_BOUNDARY of a .5 rounding boundary of the nearest resample
        c = c.double() + 0.5
        return (c - c.round()).abs() < AUG_BOUNDARY

    boundary = near(yc)[:, :, None] | near(xc)[:, None, :]
    gen = torch.Generator("cuda").manual_seed(1)
    idx = torch.arange(BATCH, device="cuda")

    def gather_augment(**draw):
        imgs, masks, wh, _ = resident.gather_batch(data, idx)
        return da.augment_batch(imgs, masks, wh, out_hw=hw, **draw)

    eager_ms = event_ms(lambda: gather_augment(generator=gen))
    result = {"batch": BATCH, "size": TRAIN_SIZE, "max_abs_err": img_err,
              "mask_pixels_differ": int(differ.sum()),
              "mask_pixels_differ_off_boundary": int((differ & ~boundary).sum()),
              "flips": int(params[3].sum()),
              # back to back from the host (the draw included), and the card's own
              # time by graph replay on fixed parameters
              "gather_augment_eager_ms": eager_ms,
              "gather_augment_card_ms": graph_ms(lambda: gather_augment(params=params), eager_ms)}
    print("resident_augment " + json.dumps(result), flush=True)
    if not (img_err <= TOL_AUG_IMAGE and result["mask_pixels_differ_off_boundary"] == 0
            and result["mask_pixels_differ"] <= AUG_MAX_BOUNDARY_SHARE * differ.numel()):
        raise AssertionError(f"augmentation, card against CPU: {result}")
    return result


def _resident_binary_model(group=None, variant: str | None = None):
    """unet_resnet50 (diff head, seed 0) and its bf16 Lovasz train step, as phase 5 builds them.

    ``group``: the step's process group (phase 12), None for one process.
    ``variant`` (phase 18): JAX's optimizer variant (``tests/torch_alternates.py``), and the
    optimizer is returned too.
    """
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules

    model = build_model("unet_resnet50", 2, diff_head=True,
                        generator=torch.Generator().manual_seed(0))
    opt = (schedules.make_train_optimizer(model.parameters(), TRAIN_LR) if variant is None
           else _alternates().make_optimizer(variant, model.parameters(), TRAIN_LR))
    step = make_binary_train_step(model, opt, "lovasz_hinge", None, amp=True, group=group)
    return (model, step) if variant is None else (model, step, opt)


def _plan(data, epoch: int, steps: int, shuffle: bool = True):
    """(host plan, the plan on the card) of ``steps`` steps of ``epoch``."""
    from unet_embroidery_seg_torch.engine import resident

    idx, mask = resident.epoch_index_plan(data.n, BATCH, epoch, shuffle, 11, steps)
    return (idx, mask), resident.upload_plan(idx, mask, "cuda")


def _host_batch(cache, idx):
    """Canvases ``idx`` normalised on the host: what the host-fed loop copies to the card."""
    from unet_embroidery_seg_torch.ops import device_augment as da

    images, pngs = da.preprocess_eval_batch(torch.from_numpy(cache.images[idx]),
                                            torch.from_numpy(cache.masks[idx]))
    return images.numpy(), pngs.numpy()


def resident_train_path(counters, cache, data) -> tuple[dict, object]:
    """11b: unet_resnet50's resident bf16 train step, beside its host-fed step. Returns the model."""
    from unet_embroidery_seg_torch.engine import resident
    from unet_embroidery_seg_torch.utils.timing import device_ms_by_group

    model, step = _resident_binary_model()
    starts: list = []

    def marked_step(*args):  # a CUDA event at each train step's start, on the card's stream
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append(ev)
        return step(*args)

    chunk = resident.make_train_chunk_fn(marked_step, (TRAIN_SIZE, TRAIN_SIZE), True, 2, seed=11)

    def run_chunk(epoch: int) -> torch.Tensor:
        _, (idx, mask) = _plan(data, epoch, RESIDENT_CHUNK)
        return chunk(data, idx, mask, epoch, range(RESIDENT_CHUNK))

    run_chunk(0).cpu()  # warm-up: cuDNN plans, kernel loads, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, step_ms, chunk_ms = [], [], []
    for epoch in (1, 2):
        starts.clear()
        t0 = time.perf_counter()
        out = run_chunk(epoch)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        losses += out.cpu().tolist()  # the chunk's one read from the card
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        marks = starts + [end]
        step_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = 2 * RESIDENT_CHUNK
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_chunk(3).cpu()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_group, _ = device_ms_by_group(prof, RESIDENT_CHUNK)
    busy_ms = sum(by_group.values())

    # Augmentation off: the chunk against the host-fed loop on the same batches,
    # from the same initial weights; then the host-fed step's time.
    off_model, off_step = _resident_binary_model()
    host_model, host_step = _resident_binary_model()
    (idx, mask), plan = _plan(data, 0, RESIDENT_COMPARED_STEPS)
    off_chunk = resident.make_train_chunk_fn(off_step, (TRAIN_SIZE, TRAIN_SIZE), True, 2,
                                             augment=False, seed=11)
    off_losses = off_chunk(data, *plan, 0, range(RESIDENT_COMPARED_STEPS)).cpu().tolist()
    host_losses = [float(host_step(*_host_batch(cache, idx[k]), mask[k]))
                   for k in range(RESIDENT_COMPARED_STEPS)]
    batch = (*_host_batch(cache, idx[0]), mask[0])
    host_ms = []
    for _ in range(HOST_FED_STEPS):
        t0 = time.perf_counter()
        float(host_step(*batch))  # float() waits for the card
        host_ms.append((time.perf_counter() - t0) * 1e3)
    rel = [abs(a - b) / abs(b) for a, b in zip(off_losses, host_losses)]
    del off_model, host_model

    result = {
        "model": "unet_resnet50", "task": "binary", "loss": "lovasz_hinge", "amp": True,
        "size": TRAIN_SIZE, "batch": BATCH, "chunk": RESIDENT_CHUNK, "steps": steps,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms, "step_ms_method": "cuda_events",
        "chunk_wall_ms_per_step": [c / RESIDENT_CHUNK for c in chunk_ms],
        # busy share: card busy ms over the (unprofiled) step median; the
        # profiler's own window runs slower on a host-bound step
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / statistics.median(step_ms),
        "profiled_wall_ms_per_step": window_ms / RESIDENT_CHUNK,
        "device_ms_by_group": by_group,
        "resident_bytes": data.nbytes, "peak_mem_gb": peak_gb,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "losses": losses, "params_without_grad": no_grad,
        "host_fed_step_ms_median": statistics.median(host_ms), "host_fed_step_ms": host_ms,
        "augment_off_losses": off_losses, "host_fed_losses": host_losses,
        "augment_off_loss_rel_diff": rel,
    }
    print("resident_train " + json.dumps(result), flush=True)
    want = {k: v * steps for k, v in RESNET_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"resident train launches {launches} != expected {want}")
    if not np.isfinite(losses).all() or no_grad:
        raise AssertionError(f"resident train: losses {losses}, without a gradient {no_grad[:5]}")
    if max(rel) > TOL_RESIDENT_LOSS:
        raise AssertionError(f"augmentation off: chunk {off_losses} != host-fed {host_losses}")
    return result, model


def resident_multitask_path(counters, data) -> dict:
    """11c: multitask_unet, bf16, one chunk of 8 resident steps (seg BCE + class CE)."""
    from unet_embroidery_seg_torch.engine import resident

    model = _task_model("multitask", "multitask_unet")
    chunk = resident.make_train_chunk_fn(_task_step("multitask", model, "bce", amp=True),
                                         (TRAIN_SIZE, TRAIN_SIZE), True, 2, multitask=True,
                                         seed=11)
    _, plan = _plan(data, 0, RESIDENT_CHUNK)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    total, seg, cls, correct = torch.stack(chunk(data, *plan, 0, range(RESIDENT_CHUNK))).cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    result = {"model": "multitask_unet", "steps": RESIDENT_CHUNK, "amp": True,
              "wall_ms_per_step_with_warm_up": wall_ms / RESIDENT_CHUNK,
              "losses": total.tolist(), "seg": seg.tolist(), "cls": cls.tolist(),
              "n_correct": correct.tolist(), "launches": launches}
    print("resident_multitask " + json.dumps(result), flush=True)
    want = {k: v * RESIDENT_CHUNK for k, v in RESNET_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"resident multitask launches {launches} != expected {want}")
    if not torch.isfinite(torch.stack([total, seg, cls])).all():
        raise AssertionError(f"resident multitask: non-finite losses {result}")
    return result


def resident_eval_check(model, cache, data) -> dict:
    """11d: the resident eval chunk's counts against the host-fed eval step's, exactly."""
    from unet_embroidery_seg_torch.engine import resident
    from unet_embroidery_seg_torch.engine.steps import make_binary_eval_step

    eval_step = make_binary_eval_step(model, "lovasz_hinge", None)
    chunk = resident.make_eval_chunk_fn(eval_step, True, 2)
    (idx, mask), plan = _plan(data, 0, 2, shuffle=False)
    _, counts = chunk(data, *plan)
    got = counts.cpu().tolist()
    want = [eval_step(*_host_batch(cache, idx[k]), mask[k])[1].cpu().tolist()
            for k in range(len(idx))]
    result = {"batches": len(idx), "resident_counts": got, "host_fed_counts": want}
    print("resident_eval " + json.dumps(result), flush=True)
    if got != want or sum(map(sum, got)) != len(idx) * BATCH * TRAIN_SIZE ** 2:
        raise AssertionError(f"resident eval counts differ from host-fed ones: {result}")
    return result


def _bn_state(c: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"weight": torch.rand(c, generator=g) + 0.5, "bias": 0.1 * torch.randn(c, generator=g),
            "running_mean": 0.1 * torch.randn(c, generator=g),
            "running_var": torch.rand(c, generator=g) + 0.5, "num_batches_tracked": torch.tensor(0)}


def sync_bn_check(group, device="cuda", shape=BN_SHAPE, timer=None) -> dict:
    """12a: the synchronised BN on a 1-rank group against the port's cuDNN BN.

    Each side's record is a copy taken right after its first call, before
    its timing (``timer``, default ``utils/timing.event_ms``) runs more
    forward + backward calls, which autograd adds into the same ``x.grad``:
    so the check does not depend on how many calls the timer makes. The
    printed line gives each side's calls in all and the range of the
    recorded dx, sync over cuDNN, over the elements whose cuDNN value is at
    least 1% of its largest. ``device``, ``shape`` and ``timer`` let a CPU
    test drive it on a gloo group.
    """
    from unet_embroidery_seg_torch.models.blocks import BatchNorm, set_batchnorm_group

    if timer is None:
        from unet_embroidery_seg_torch.utils.timing import event_ms as timer
    device = torch.device(device)
    c = shape[1]
    gen = torch.Generator(device).manual_seed(12)
    cl = torch.channels_last
    x0 = (2.0 * torch.randn(shape, generator=gen, device=device) + 0.5).contiguous(
        memory_format=cl)
    gy = torch.randn(shape, generator=gen, device=device).contiguous(memory_format=cl)
    result = {"shape": list(shape), "site": "unet_resnet50 resnet.layer1.*.bn3 at 512^2"}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        runs, calls = {}, {}
        for name, grp in (("cudnn", None), ("sync", group)):
            bn = BatchNorm(c).to(device)
            bn.load_state_dict(_bn_state(c, 12))
            set_batchnorm_group(bn.train(), grp)
            x = x0.to(dtype).clone().requires_grad_(True)
            calls[name] = 0

            def fwd_bwd(bn=bn, x=x, name=name):
                calls[name] += 1
                with torch.autocast(device.type, dtype=torch.bfloat16, enabled=label == "bf16"):
                    y = bn(x)
                (y.float() * gy).sum().backward()
                return y

            y = fwd_bwd()
            runs[name] = {"y": y.detach().clone().float(), "dx": x.grad.clone().float(),
                          "dw": bn.weight.grad.clone(), "db": bn.bias.grad.clone(),
                          "running_mean": bn.running_mean.clone(),
                          "running_var": bn.running_var.clone()}
            runs[name]["forward_backward_ms"] = timer(fwd_bwd)
        errs = {k: ((runs["sync"][k] - v).abs().max() / v.abs().max()).item()
                for k, v in runs["cudnn"].items() if k != "forward_backward_ms"}
        ref = runs["cudnn"]["dx"]
        big = ref.abs() >= 0.01 * ref.abs().max()
        ratio = runs["sync"]["dx"][big] / ref[big]
        result[label] = {"rel_err": errs, "calls": calls,
                         "dx_ratio_range": [ratio.min().item(), ratio.max().item()],
                         "sync_forward_backward_ms": runs["sync"]["forward_backward_ms"],
                         "cudnn_forward_backward_ms": runs["cudnn"]["forward_backward_ms"],
                         "ms_method": "cuda_events_eager"}
    print("sync_batchnorm " + json.dumps(result), flush=True)
    for label in ("f32", "bf16"):
        bad = {k: v for k, v in result[label]["rel_err"].items()
               if not v <= (TOL_SYNC_BN[label] if k in ("y", "dx", "dw", "db")
                            else TOL_SYNC_BN["f32"])}
        if bad:
            raise AssertionError(f"synchronised BN against cuDNN's, {label}: {bad}")
    return result


def _resident_chunks(mesh, counters, data, profile: bool = False) -> dict:
    """11b's bf16 Lovasz resident chunk of unet_resnet50 on ``mesh`` (None: one process).

    Epoch 0's 8 losses from seed-0 weights (the comparisons' run), then a
    chunk of epoch 1 with the counters zeroed just before and read just
    after: launches, ms/step by CUDA events, peak memory; with ``profile``
    a third, profiled chunk gives the card's busy ms per step.
    """
    from unet_embroidery_seg_torch.engine import resident
    from unet_embroidery_seg_torch.utils.timing import device_ms_by_group

    model, step = _resident_binary_model(None if mesh is None else mesh.group)
    starts: list = []

    def marked_step(*args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append(ev)
        return step(*args)

    chunk = resident.make_train_chunk_fn(marked_step, (TRAIN_SIZE, TRAIN_SIZE), True, 2, seed=11,
                                         mesh=mesh)

    def run(epoch: int) -> torch.Tensor:
        idx, mask = resident.epoch_index_plan(data.n, BATCH, epoch, True, 11, RESIDENT_CHUNK)
        plan = resident.upload_plan(idx, mask, data.images_u8.device)
        return chunk(data, *plan, epoch, range(RESIDENT_CHUNK))

    losses = run(0).cpu().tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    starts.clear()
    t0 = time.perf_counter()
    out = run(1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    out.cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    marks = starts + [end]
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    result = {"losses": losses, "launches": launches, "step_ms_median": statistics.median(step_ms),
              "step_ms": step_ms, "step_ms_method": "cuda_events",
              "chunk_wall_ms_per_step": wall_ms / RESIDENT_CHUNK,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile:
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            run(2).cpu()
        by_group, _ = device_ms_by_group(prof, RESIDENT_CHUNK)
        result["device_busy_ms_per_step"] = sum(by_group.values())
        result["device_ms_by_group"] = by_group
    want = {c.__name__: RESNET_PER_STEP[c.__name__] * RESIDENT_CHUNK for c in counters}
    if launches != want or not np.isfinite(losses).all():
        raise AssertionError(f"resident chunk: launches {launches} != {want}, or losses {losses}")
    del model, step
    torch.cuda.empty_cache()
    return result


def _sgd_model_and_batch(device):
    """12b's f32 SGD case: unet_resnet50 (diff head, seed 12) on ``device`` and a seeded batch."""
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.models import build_model

    model = build_model("unet_resnet50", 2, diff_head=True,
                        generator=torch.Generator().manual_seed(12), device=device)
    return model, seeded_train_batch(BATCH, TRAIN_SIZE, seed=12)


def _sgd_step(model, batch, group=None, space=None) -> float:
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step

    opt = torch.optim.SGD(model.parameters(), lr=DDP_LR_SGD)
    step = make_binary_train_step(model, opt, "lovasz_hinge", None, amp=False, group=group,
                                  space=space)
    return float(step(*batch))


def _ddp_rank(rank: int, devices: list, out_dir: str, sgd: bool) -> None:
    """One rank of 12b (gloo, two ranks on one card) or 12d (NCCL, a card each).

    f32 SGD step (``sgd``; its state dict saved for the parent), then the
    bf16 resident chunks; the results go to ``out_dir/rank<r>.json``.
    """
    import torch.distributed as dist

    from unet_embroidery_seg_torch.data.synthetic import resident_canvases
    from unet_embroidery_seg_torch.engine import resident
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(devices=devices)
    result = {"rank": rank, "world_size": mesh.world_size, "device": str(mesh.device),
              "backend": dist.get_backend()}
    if sgd:
        model, batch = _sgd_model_and_batch(mesh.device)
        result["sgd_loss"] = _sgd_step(model, mesh_lib.shard_batch_arrays(mesh, *batch),
                                       mesh.group)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   os.path.join(out_dir, f"rank{rank}_sgd.pt"))
        del model
        torch.cuda.empty_cache()
    data = resident.upload(resident_canvases(RESIDENT_CANVASES, TRAIN_SIZE, seed=11,
                                             cls_labels=True), mesh.device)
    counters = [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad]
    result["chunk"] = _resident_chunks(mesh, counters, data)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _run_ranks(devices: list, backend: str, sgd: bool) -> tuple[list[dict], str, float]:
    """``_ddp_rank`` on ``len(devices)`` new processes; (their results, their folder, seconds)."""
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    out_dir = tempfile.mkdtemp(prefix="ddp-ranks-")
    t0 = time.perf_counter()
    mesh_lib.launch_local(_ddp_rank, len(devices), (devices, out_dir, sgd), backend=backend,
                          timeout_s=900)
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(len(devices)):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, out_dir, seconds


def _update_rel(state: dict, ref: dict, init: dict, stats: bool) -> dict:
    """Per tensor, ||change - reference change|| / ||reference change|| (parameters or BN statistics)."""
    out = {}
    for k, p0 in init.items():
        if not torch.is_floating_point(p0) or k.endswith(("running_mean", "running_var")) != stats:
            continue
        du = ref[k] - p0
        out[k] = ((state[k] - p0 - du).norm() / du.norm().clamp_min(1e-30)).item()
    return out


def _update_rule(state: dict, ref: dict, up: dict, down: dict, init: dict) -> tuple[dict, bool]:
    """12b's rule for one f32 step: ``state``'s update against ``ref``'s, per tensor, within 4x
    the floor of ``up`` and ``down`` (``ref``'s step with its input moved one ulp) plus 1e-4.

    Returns ({"parameter_updates", "bn_statistics"}: median and worst share and floor), ok).
    """
    entries, ok = {}, True
    for stats in (False, True):
        two = _update_rel(state, ref, init, stats)
        noise = {k: max(a, b) for (k, a), b in zip(_update_rel(up, ref, init, stats).items(),
                                                   _update_rel(down, ref, init, stats).values())}
        worst = max(two, key=two.get)
        entry = {"median_rel_diff": statistics.median(two.values()),
                 "median_rel_noise": statistics.median(noise.values()),
                 "worst_rel_diff": two[worst], "worst": worst,
                 "worst_rel_noise": max(noise.values())}
        entries["bn_statistics" if stats else "parameter_updates"] = entry
        floor = lambda v: TOL_TRAIN_NOISE_FACTOR * v + TOL_F32_GRAD  # noqa: E731
        ok = ok and (entry["median_rel_diff"] <= floor(entry["median_rel_noise"])
                     and entry["worst_rel_diff"] <= floor(entry["worst_rel_noise"]))
    return entries, ok


def two_ranks_one_card(one_process: dict, bf16_floor: float) -> dict:
    """12b: two gloo ranks on the one card against the 1-process step and chunk.

    ``bf16_floor``: the largest relative loss difference between two
    1-process bf16 chunks that differ only in rounding (12c: the
    synchronised BN on a 1-rank group against cuDNN's), which Adam's
    updates carry from step to step.
    """
    init, batch = _sgd_model_and_batch("cpu")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    one = {}
    for run, scale in (("one", 1.0), ("one_up", 1 + 2.0 ** -23), ("one_down", 1 - 2.0 ** -23)):
        model, _ = _sgd_model_and_batch("cuda")
        images, pngs, sm = batch
        loss = _sgd_step(model, (images * np.float32(scale), pngs, sm))
        one[run] = (loss, {k: v.cpu() for k, v in model.state_dict().items()})
        del model
    torch.cuda.empty_cache()
    ranks, out_dir, seconds = _run_ranks([torch.device("cuda", 0)] * DDP_RANKS, "gloo", sgd=True)
    states = [torch.load(os.path.join(out_dir, f"rank{r}_sgd.pt"), weights_only=True)
              for r in range(DDP_RANKS)]
    shutil.rmtree(out_dir, ignore_errors=True)
    bit_equal = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    ref = one["one"][1]
    result = {"ranks": DDP_RANKS, "backend": "gloo", "devices": "cuda:0 x2", "seconds": seconds,
              "sgd": {"lr": DDP_LR_SGD, "loss_two_ranks": ranks[0]["sgd_loss"],
                      "loss_one_process": one["one"][0],
                      "loss_rel_diff": abs(ranks[0]["sgd_loss"] - one["one"][0])
                      / abs(one["one"][0]),
                      "ranks_bit_equal": bit_equal}}
    entries, ok = _update_rule(states[0], ref, one["one_up"][1], one["one_down"][1], init)
    result["sgd"].update(entries)
    ok = ok and bit_equal and result["sgd"]["loss_rel_diff"] <= TOL_DDP_LOSS_F32
    want = one_process["losses"]
    got = [r["chunk"]["losses"] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[0], want)]
    result["bf16_chunk"] = {
        "losses_two_ranks": got[0], "losses_one_process": want, "loss_rel_diff": rel,
        "rounding_floor": bf16_floor,
        "launches_per_rank": [r["chunk"]["launches"] for r in ranks],
        "step_ms_median_per_rank": [r["chunk"]["step_ms_median"] for r in ranks],
        "step_ms_per_rank": [r["chunk"]["step_ms"] for r in ranks],
        "peak_mem_gb_per_rank": [r["chunk"]["peak_mem_gb"] for r in ranks],
        "one_process_step_ms_median": one_process["step_ms_median"],
        "one_process_peak_mem_gb": one_process["peak_mem_gb"]}
    print("ddp_two_ranks_one_card " + json.dumps(result), flush=True)
    ok = (ok and got[0] == got[1] and rel[0] <= TOL_RESIDENT_LOSS
          and max(rel) <= max(TOL_RESIDENT_LOSS, DDP_BF16_FLOOR_FACTOR * bf16_floor))
    if not ok:
        raise AssertionError(f"two ranks on one card against one process: {result}")
    return result


def ddp_one_card(one_process: dict, counters, data, group) -> dict:
    """12c: DDP with the synchronised BN over a 1-rank NCCL group against the unwrapped step."""
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.Mesh(0, 1, torch.device("cuda", 0), group)
    ddp = _resident_chunks(mesh, counters, data, profile=True)
    rels = [abs(a - b) / abs(b) for a, b in zip(ddp["losses"], one_process["losses"])]
    rel = rels[0]
    result = {"backend": "nccl", "world_size": 1, "ddp": ddp, "unwrapped": one_process,
              "first_loss_rel_diff": rel, "loss_rel_diff": rels,
              "step_ms_median_ddp_minus_unwrapped": ddp["step_ms_median"]
              - one_process["step_ms_median"],
              "busy_ms_ddp_minus_unwrapped": ddp["device_busy_ms_per_step"]
              - one_process["device_busy_ms_per_step"]}
    print("ddp_one_card " + json.dumps(result), flush=True)
    if rel > TOL_DDP_LOSS_BF16:
        raise AssertionError(f"DDP at world size 1 against the unwrapped step: {result}")
    return result


def two_cards(one_process: dict, bf16_floor: float = 0.0) -> dict:
    """12d: the train CLI with --mesh-data 2 over NCCL, and 12b's chunk on two cards.

    The chunk's losses are held as 12b's (``bf16_floor``: 12c's rounding floor).
    """
    n = torch.cuda.device_count()
    if n < 2:
        reason = (f"phase 12d not run: this machine has {n} CUDA card, and a data axis of 2 "
                  "over NCCL needs two")
        print(reason, flush=True)
        return {"ran": False, "reason": reason}
    ranks, out_dir, seconds = _run_ranks([torch.device("cuda", i) for i in range(2)], "nccl",
                                         sgd=False)
    shutil.rmtree(out_dir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="ddp-cli-")
    cmd = [sys.executable, "-m", "unet_embroidery_seg_torch.train", "--data-path",
           "synthetic:16", "--input-size", str(TRAIN_SIZE), "--batch-size", str(BATCH),
           "--epochs", "1", "--max-train-batches", "4", "--max-val-batches", "1",
           "--max-test-batches", "1", "--mesh-data", "2", "--no-export-vis",
           "--ckpt-every", "0"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    # its own session: on a timeout the CLI and the ranks it started all go
    proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, stderr = proc.communicate()
    cli_s = time.perf_counter() - t0
    runs = sorted(os.listdir(os.path.join(workdir, "run", "train"))) if proc.returncode == 0 \
        else []
    files = sorted(os.listdir(os.path.join(workdir, "run", "train", "exp"))) if runs else []
    shutil.rmtree(workdir, ignore_errors=True)
    result = {"ran": True, "cards": n, "backend": "nccl", "seconds": seconds,
              "losses_two_cards": ranks[0]["chunk"]["losses"],
              "losses_one_card": one_process["losses"],
              "step_ms_median_per_rank": [r["chunk"]["step_ms_median"] for r in ranks],
              "launches_per_rank": [r["chunk"]["launches"] for r in ranks],
              "peak_mem_gb_per_rank": [r["chunk"]["peak_mem_gb"] for r in ranks],
              "one_card_step_ms_median": one_process["step_ms_median"],
              "cli": {"returncode": proc.returncode, "seconds": cli_s, "runs": runs,
                      "files": files, "stderr_tail": stderr[-4000:]}}
    print("ddp_two_cards " + json.dumps(result), flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["chunk"]["losses"],
                                               one_process["losses"])]
    if (proc.returncode != 0 or runs != ["exp"] or "summary.json" not in files
            or rel[0] > TOL_RESIDENT_LOSS
            or max(rel) > max(TOL_RESIDENT_LOSS, DDP_BF16_FLOOR_FACTOR * bf16_floor)):
        raise AssertionError(f"two cards: {result}")
    return result


def data_parallel_phase(counters, data) -> dict:
    """Phase 12: 12a and 12c on a 1-rank NCCL group, 12b's two ranks, 12d's two cards."""
    import torch.distributed as dist

    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="nccl-1-rank-")
    mesh_lib.init_multihost(f"file://{os.path.join(store, 'store')}", 1, 0, backend="nccl")
    try:
        out = {"sync_batchnorm": sync_bn_check(dist.group.WORLD)}
        one_process = _resident_chunks(None, counters, data, profile=True)
        out["ddp_one_card"] = ddp_one_card(one_process, counters, data, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["two_ranks_one_card"] = two_ranks_one_card(
        one_process, max(out["ddp_one_card"]["loss_rel_diff"]))
    out["two_cards"] = two_cards(one_process, max(out["ddp_one_card"]["loss_rel_diff"]))
    out["seconds"] = time.perf_counter() - t0
    return out


def opcheck_on_card() -> dict:
    """13a: ``torch.library.opcheck`` of each operator at one site shape, bf16 and f32."""
    from unet_embroidery_seg_torch.ops.conv3x3 import pack_conv3x3_grad
    from unet_embroidery_seg_torch.ops.library import registered_ops

    ops = registered_ops()
    gen = torch.Generator().manual_seed(13)

    def act(c, h, dtype, extra_c=0):
        x = torch.randn(BATCH, c + extra_c, h, h, generator=gen).to("cuda", dtype)
        return x.contiguous(memory_format=torch.channels_last)[:, extra_c:]

    def weights(c):
        w = torch.randn(c, c, 3, 3, generator=gen) / (3.0 * c ** 0.5)
        return w.cuda(), (0.1 * torch.randn(c, generator=gen)).cuda()

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        c_up, h_up = OPCHECK_SHAPES["upsample2x"]
        c_bw, h_bw, skip = OPCHECK_SHAPES["upsample2x_backward"]
        w1, b1 = weights(OPCHECK_SHAPES["conv3x3_bias_relu"][0])
        w2, _ = weights(OPCHECK_SHAPES["conv3x3_same"][0])
        w3, _ = weights(OPCHECK_SHAPES["conv3x3_dgrad"][0])
        cases = {
            "upsample2x": (act(c_up, h_up, dtype), True),
            # the cat gradient's channel slice, read in place
            "upsample2x_backward": (act(c_bw, 2 * h_bw, dtype, skip), True),
            "conv3x3_bias_relu": (act(*OPCHECK_SHAPES["conv3x3_bias_relu"], dtype), w1, b1, True),
            "conv3x3_same": (act(*OPCHECK_SHAPES["conv3x3_same"], dtype), w2, True),
            "conv3x3_dgrad": (act(*OPCHECK_SHAPES["conv3x3_dgrad"], dtype), w3,
                              pack_conv3x3_grad(w3, dtype)),
        }
        for name, args in cases.items():
            t0 = time.perf_counter()
            res = torch.library.opcheck(ops[name], args)  # raises on a failed check
            out[f"{name}[{dtype}]"] = {"shape": list(args[0].shape), **res,
                                       "seconds": time.perf_counter() - t0}
        del cases
    torch.cuda.empty_cache()
    print("opcheck " + json.dumps(out), flush=True)
    return out


def _aten_ops_per_call(fn, x) -> int:
    """The operators ``fn(x)`` dispatches (below autograd): the host's work in ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Count():
        fn(x)
    return Count.n


def _serving_times(fns: dict, x) -> dict:
    """Median card ms per call (CUDA events around each call) and host ms per call of each fn.

    The fns run in turns (a, b, b, a, a, b, b, a), ``SERVING_CALLS`` calls a
    turn, so a drift of the host's speed falls on both alike.
    """
    card: dict = {k: [] for k in fns}
    host: dict = {k: [] for k in fns}
    with torch.no_grad():
        for name in (list(fns) + list(fns)[::-1]) * 2:
            fn = fns[name]
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            marks = []
            for _ in range(SERVING_CALLS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                fn(x)
                host[name].append((time.perf_counter() - t0) * 1e3)
                end.record()
                marks.append((start, end))
            torch.cuda.synchronize()
            card[name] += [a.elapsed_time(b) for a, b in marks]
    return {k: {"ms_median": statistics.median(card[k]),
                "host_ms_median": statistics.median(host[k])} for k in fns}


def serving_phase(counters) -> dict:
    """13b and 13c: unet_resnet50's serving artifacts on the card, against eager predict."""
    from unet_embroidery_seg_torch import export_serving
    from unet_embroidery_seg_torch.data.synthetic import letterboxed_canvases
    from unet_embroidery_seg_torch.engine import checkpoint
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.predict import predict_probs

    workdir = tempfile.mkdtemp(prefix="serving-")
    allow_tf32 = torch.backends.cudnn.allow_tf32
    try:
        model = build_model("unet_resnet50", 2, generator=torch.Generator().manual_seed(0))
        weights = os.path.join(workdir, "unet_resnet50_seed0.pth")
        checkpoint.save_weights(weights, model)
        canvases = letterboxed_canvases(2 * BATCH, SIZE, seed=0)
        out = {}
        for label, batches in SERVING_BATCHES.items():
            amp = label == "bf16"
            t0 = time.perf_counter()
            # the CLI, --check included; it states the float32 precision
            # (cuDNN TF32 on, as every CLI), restored below
            manifest = export_serving.main(
                ["--weights", weights, "--model", "unet_resnet50", "--input-size", str(SIZE),
                 "--batches", *map(str, batches), "--platforms", "cuda",
                 "--out", os.path.join(workdir, label), "--check"] + ([] if amp else ["--no-amp"]))
            export_s = time.perf_counter() - t0
            predict_fn = make_predict_fn(model, amp)
            eager = export_serving.build_predict(model, amp)
            paths = square_conv_paths(model, torch.bfloat16 if amp else torch.float32)
            if not amp and paths != F32_FUSED_PATHS:
                raise AssertionError(f"f32 artifact: fused sites on {paths}, not on "
                                     f"{F32_FUSED_PATHS}")
            for b in batches:
                art = manifest["artifacts"][str(b)]["cuda"]
                module = export_serving.load_artifact(os.path.join(workdir, label, art["file"]))
                err = 0.0
                with torch.no_grad():
                    for start in range(0, len(canvases), b):
                        chunk = canvases[start : start + b]
                        got = module(torch.from_numpy(chunk).cuda()).cpu().numpy()
                        err = max(err, float(np.abs(got - predict_probs(predict_fn, chunk)).max()))
                    x = torch.from_numpy(canvases[:b]).cuda()
                    torch.cuda.synchronize()
                    for c in counters:
                        c.launches = 0
                    probs = module(x)
                    torch.cuda.synchronize()
                    launches = {c.__name__: c.launches for c in counters}
                want = {c.__name__: 0 for c in counters} | {"upsample2x": 5, "conv3x3_bias_relu": 6}
                with torch.no_grad():  # the export as torch.export gives it, asserts and all
                    exported = torch.export.export(eager, (x,)).module()
                ops = {"artifact": _aten_ops_per_call(module, x),
                       "eager": _aten_ops_per_call(eager, x),
                       "torch_export_as_given": _aten_ops_per_call(exported, x)}
                del exported
                row = {"file": art["file"], "bytes": art["bytes"],
                       "check_max_abs_diff": art["check_max_abs_diff"],
                       "max_abs_diff_vs_predict_probs": err, "launches_per_forward": launches,
                       "aten_ops_per_forward": ops,
                       **_serving_times({"artifact": module, "eager": eager}, x),
                       "square_conv_paths": paths}
                print(f"serving[{label},b{b}] " + json.dumps(row), flush=True)
                if (launches != want or not err <= export_serving.CHECK_TOLERANCE
                        or probs.shape != (b, SIZE, SIZE, 2) or ops["artifact"] > ops["eager"]):
                    raise AssertionError(f"serving artifact {art['file']}: launches {launches} "
                                         f"!= {want}, max abs diff {err}, or ops {ops}")
                out[f"{label}_b{b}"] = row
                del module, probs
            out[f"{label}_export_seconds"] = export_s
            torch.cuda.empty_cache()
        out["bf16_b1_unbaked"] = unbaked_artifact(model, weights, canvases, workdir, counters)
        return out
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
        shutil.rmtree(workdir, ignore_errors=True)


def unbaked_artifact(model, weights: str, canvases, workdir: str, counters) -> dict:
    """13f: the ``--no-bake-weights`` artifact (bf16, batch 1) on the card against eager predict.

    The artifact takes the model's state dict at every call; on each of the
    canvases it must equal ``predict_probs`` of the eager model within the
    ``--check`` rule, with 5 upsample and 6 fused-conv launches per forward.
    """
    from unet_embroidery_seg_torch import export_serving
    from unet_embroidery_seg_torch.engine.steps import make_predict_fn
    from unet_embroidery_seg_torch.predict import predict_probs

    out_dir = os.path.join(workdir, "unbaked")
    manifest = export_serving.main(
        ["--weights", weights, "--model", "unet_resnet50", "--input-size", str(SIZE),
         "--batches", "1", "--platforms", "cuda", "--out", out_dir, "--check",
         "--no-bake-weights"])
    art = manifest["artifacts"]["1"]["cuda"]
    module = export_serving.load_artifact(os.path.join(out_dir, art["file"]))
    predict_fn = make_predict_fn(model, True)
    state = model.state_dict()
    err = 0.0
    with torch.no_grad():
        for i in range(len(canvases)):
            got = module(state, torch.from_numpy(canvases[i : i + 1]).cuda()).cpu().numpy()
            err = max(err, float(np.abs(got - predict_probs(predict_fn, canvases[i : i + 1]))
                                 .max()))
        x = torch.from_numpy(canvases[:1]).cuda()
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        module(state, x)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: 0 for c in counters} | {"upsample2x": 5, "conv3x3_bias_relu": 6}
    row = {"file": art["file"], "bytes": art["bytes"], "baked_weights": manifest["baked_weights"],
           "check_max_abs_diff": art["check_max_abs_diff"],
           "max_abs_diff_vs_predict_probs": err, "canvases": len(canvases),
           "launches_per_forward": launches}
    print("serving[bf16,b1,unbaked] " + json.dumps(row), flush=True)
    if (manifest["baked_weights"] or launches != want
            or not err <= export_serving.CHECK_TOLERANCE):
        raise AssertionError(f"--no-bake-weights artifact: launches {launches} != {want} or "
                             f"max abs diff {err}")
    return row


def _kernel_role(name: str) -> str | None:
    """Which hand-written kernel a CUDA kernel event's (demangled) name is, or None.

    The conv kernels' last two template flags are BIAS_RELU, on in
    unet_resnet50's forward, and DGRAD, on in its dgrad (``void (anonymous
    namespace)::tc::conv3x3_wgmma_kernel<__nv_bfloat16, 128, 0, true,
    false>(...)`` at C > 64, ``...::tc::conv3x3_c64_kernel<true, false>(...)``
    at C <= 64).
    """
    for role, key in (("upsample2x", "::upsample2x_kernel<"),
                      ("upsample2x_backward", "::upsample2x_bwd_kernel<")):
        if key in name:
            return role
    key = next((k for k in ("::conv3x3_wgmma_kernel<", "::conv3x3_c64_kernel<") if k in name), None)
    if key is None:
        return None
    flags = [f.strip() for f in name.split(key, 1)[1].split(">", 1)[0].split(",")]
    return ("conv3x3 forward" if flags[-2] == "true" else "conv3x3 dgrad" if flags[-1] == "true"
            else None)


def profile_cli() -> dict:
    """13d: the train CLI's --profile on the card: the trace and the HBM line."""
    import glob
    import re

    workdir = tempfile.mkdtemp(prefix="profile-cli-")
    cmd = [sys.executable, "-m", "unet_embroidery_seg_torch.train", "--data-path",
           f"synthetic:{PROFILE_TRAIN_BATCHES * BATCH}", "--model", "unet_resnet50",
           "--input-size", str(TRAIN_SIZE), "--batch-size", str(BATCH), "--epochs", "1",
           "--max-train-batches", str(PROFILE_TRAIN_BATCHES), "--scan-chunk", str(PROFILE_CHUNK),
           "--max-val-batches", "1", "--max-test-batches", "1", "--no-export-vis",
           "--ckpt-every", "0", "--profile"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    try:
        traces = glob.glob(os.path.join(workdir, "run", "train", "exp", "trace", "*.json"))
        kernels = {"upsample2x": 0, "upsample2x_backward": 0, "conv3x3 forward": 0,
                   "conv3x3 dgrad": 0}
        ops, n_events, trace_bytes = {}, 0, 0
        if len(traces) == 1:
            trace_bytes = os.path.getsize(traces[0])
            with open(traces[0]) as f:
                events = json.load(f)["traceEvents"]
            n_events = len(events)
            for e in events:
                name = str(e.get("name", ""))
                if e.get("cat") == "kernel" and _kernel_role(name) is not None:
                    kernels[_kernel_role(name)] += 1
                elif name.startswith("unet_seg::"):
                    ops[name] = ops.get(name, 0) + 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    hbm = [tuple(map(int, m)) for m in re.findall(r"HBM: (\d+)/(\d+)MB", stdout)]
    result = {"returncode": proc.returncode, "seconds": time.perf_counter() - t0,
              "traces": len(traces), "trace_bytes": trace_bytes, "trace_events": n_events,
              "kernels_in_window": kernels, "operator_events_in_window": ops, "hbm_mb": hbm,
              "stderr_tail": stderr[-3000:] if proc.returncode else ""}
    print("profile_cli " + json.dumps(result), flush=True)
    per_step = {"upsample2x": 5, "upsample2x_backward": 5, "conv3x3 forward": 6,
                "conv3x3 dgrad": 6}
    want_ops = {"unet_seg::upsample2x": 5, "unet_seg::upsample2x_backward": 5,
                "unet_seg::conv3x3_bias_relu": 6, "unet_seg::conv3x3_dgrad": 6}
    if (proc.returncode != 0 or len(traces) != 1
            or kernels != {k: PROFILE_CHUNK * v for k, v in per_step.items()}
            or ops != {k: PROFILE_CHUNK * v for k, v in want_ops.items()}
            or not hbm or not all(used > 0 for used, _ in hbm)):
        raise AssertionError(f"--profile on the card: {result}")
    return result


def _host_us_per_call(fn, args) -> float:
    """Host us per call over a run of ``DISPATCH_CALLS`` calls (the card keeps up: tiny shapes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCH_CALLS):
        fn(*args)
    us = (time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS
    torch.cuda.synchronize()
    return us


def dispatch_cost(counters, data, resident_step_ms: float) -> dict:
    """13e: what the operators' dispatch adds on the host, per call and per resident step.

    Per call: each operator against its CUDA implementation called
    directly, on tiny tensors, in turns (direct, operator, operator,
    direct). Per step: 11b's resident chunk with the autograd Functions
    calling the operators (as shipped) and calling the CUDA implementations
    directly (the module globals swapped for the run), in the same turns.
    """
    from unet_embroidery_seg_torch.ops import conv3x3 as conv_mod
    from unet_embroidery_seg_torch.ops import upsample as up_mod

    direct = {  # module, operator global, its CUDA implementation
        "upsample2x": (up_mod, "upsample2x_op", up_mod._upsample2x_cuda),
        "upsample2x_backward": (up_mod, "upsample2x_backward_op",
                                up_mod._upsample2x_backward_cuda),
        "conv3x3_bias_relu": (conv_mod, "conv3x3_bias_relu_op", conv_mod._conv3x3_bias_relu_cuda),
        "conv3x3_same": (conv_mod, "conv3x3_same_op", conv_mod._conv3x3_same_cuda),
        "conv3x3_dgrad": (conv_mod, "conv3x3_dgrad_op", conv_mod._conv3x3_dgrad_cuda),
    }
    x = torch.randn(1, 64, 8, 8, device="cuda", dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.randn(64, 64, 3, 3, device="cuda") * 0.05, torch.zeros(64, device="cuda")
    args = {"upsample2x": (x, True), "upsample2x_backward": (x, True),
            "conv3x3_bias_relu": (x, w, b, True), "conv3x3_same": (x, w, True),
            "conv3x3_dgrad": (x, w, conv_mod.pack_conv3x3_grad(w, x.dtype))}
    per_call = {}
    with torch.no_grad():
        for name, (mod, op_name, impl) in direct.items():
            op = getattr(mod, op_name)
            _host_us_per_call(op, args[name])  # warm-up
            d1, o1, o2, d2 = (_host_us_per_call(f, args[name]) for f in (impl, op, op, impl))
            per_call[name] = {"operator_us": (o1 + o2) / 2, "direct_us": (d1 + d2) / 2,
                              "dispatch_us": (o1 + o2 - d1 - d2) / 2}

    def chunk_ms(use_ops: bool) -> float:
        saved = {name: getattr(mod, op_name) for name, (mod, op_name, _) in direct.items()}
        try:
            if not use_ops:
                for mod, op_name, impl in direct.values():
                    setattr(mod, op_name, impl)
            return _resident_chunks(None, counters, data)["step_ms_median"]
        finally:
            for name, (mod, op_name, _) in direct.items():
                setattr(mod, op_name, saved[name])

    turns = [("direct", chunk_ms(False)), ("operators", chunk_ms(True)),
             ("operators", chunk_ms(True)), ("direct", chunk_ms(False))]
    ops_ms = statistics.mean(t for k, t in turns if k == "operators")
    direct_ms = statistics.mean(t for k, t in turns if k == "direct")
    calls_per_step = sum(RESNET_PER_STEP.values())
    result = {"per_call": per_call, "resident_step_ms_turns": turns,
              "resident_step_ms_operators": ops_ms, "resident_step_ms_direct": direct_ms,
              "added_ms_per_step": ops_ms - direct_ms, "calls_per_step": calls_per_step,
              "ms_per_step_from_per_call": sum(n * per_call[k]["dispatch_us"]
                                               for k, n in RESNET_PER_STEP.items()) / 1e3,
              "phase_11b_step_ms_median": resident_step_ms}
    print("dispatch_cost " + json.dumps(result), flush=True)
    return result


def tooling_phase(counters, data, resident_step_ms: float) -> dict:
    """Phase 13: operators on the card, the serving artifact, --profile, the dispatch cost."""
    t0 = time.perf_counter()
    out = {"opcheck": opcheck_on_card(), "serving": serving_phase(counters),
           "profile_cli": profile_cli(),
           "dispatch": dispatch_cost(counters, data, resident_step_ms)}
    out["seconds"] = time.perf_counter() - t0
    return out


def _exp_configs(cwd: str) -> list[dict]:
    """The config.json of each ``run/train/expN`` under ``cwd``, in the order of N."""
    import glob

    exps = glob.glob(os.path.join(cwd, "run", "train", "exp*"))
    out = []
    for exp in sorted(exps, key=lambda p: int(os.path.basename(p)[3:] or 0)):
        with open(os.path.join(exp, "config.json")) as f:
            out.append(json.load(f))
    return out


def _fit_sites(model: str) -> dict:
    """{launch counter: launches per forward} of ``model``'s kernel sites."""
    if model in ("unet_resnet50", "multitask_unet"):
        return {k: RESNET_PER_STEP[k] for k in ("upsample2x", "conv3x3_bias_relu",
                                                "conv3x3_same")}
    return FAMILY_FORWARD_LAUNCHES[model]


def _check_fit_launches(fit: dict) -> dict:
    """The launches one fit should have made: its sites times its forwards (train and eval),
    the backward kernels' its sites times its train forwards."""
    per = _fit_sites(fit["model"])
    n_all, n_train = fit["forwards"]["train"] + fit["forwards"]["eval"], fit["forwards"]["train"]
    want = {"upsample2x": per["upsample2x"] * n_all,
            "upsample2x_backward": per["upsample2x"] * n_train,
            "conv3x3_bias_relu": per["conv3x3_bias_relu"] * n_all,
            "conv3x3_same": per["conv3x3_same"] * n_all,
            "conv3x3_dgrad": (per["conv3x3_bias_relu"] + per["conv3x3_same"]) * n_train}
    if fit["launches"] != want or n_train != PIPELINE_STEPS:
        raise AssertionError(f"pipeline fit {fit['model']}+{fit['loss']}: launches "
                             f"{fit['launches']} != {want}, or {n_train} train steps "
                             f"!= {PIPELINE_STEPS}")
    return want


def pipeline_phase(counters) -> dict:
    """Phase 14: the paper pipeline (``unet_embroidery_seg_torch.pipeline``) on the card.

    Three legs, each in a working directory of its own: binary with every
    stage (10 fits), multiclass to stage 1 (2 fits), multitask (1 fit), at
    512^2, full width, ``--no-amp`` as ``run.sh`` trains. Each fit is timed
    and its kernel launches and model forwards (train, eval) are counted.
    Fails unless the fits' (task, model, loss) follow ``pipeline.plan``
    with the winner picked, every config.json records an f32 run on the
    card, the tables hold a row per fit (multitask renders none, as
    ``run.sh``), every square conv site is on an f32 tensor-core path
    (``TF32X3_PATHS``), and each fit's launches are its sites times its
    forwards (backward: train forwards).
    """
    from unet_embroidery_seg_torch import pipeline
    from unet_embroidery_seg_torch import train as train_cli
    from unet_embroidery_seg_torch.ops.conv3x3 import TF32X3_PATHS

    fits: list[dict] = []
    forwards: list[bool] = []
    paths: list[dict] = []
    real_fit, real_build = pipeline.run_fit, train_cli.build_model

    def counted_build(*args, **kwargs):
        model = real_build(*args, **kwargs)
        paths.append(square_conv_paths(model, torch.float32))
        model.register_forward_pre_hook(lambda m, a: forwards.append(torch.is_grad_enabled()))
        return model

    def counted_fit(argv):
        forwards.clear()
        before = {c.__name__: c.launches for c in counters}
        t0 = time.perf_counter()
        exp = real_fit(argv)
        fits.append({"model": argv[argv.index("--model") + 1],
                     "loss": argv[argv.index("--loss") + 1], "exp": exp,
                     "seconds": time.perf_counter() - t0,
                     "launches": {c.__name__: c.launches - before[c.__name__] for c in counters},
                     "forwards": {"train": sum(forwards), "eval": len(forwards) - sum(forwards)}})
        return exp

    workdir = tempfile.mkdtemp(prefix="pipeline-")
    cwd = os.getcwd()
    out: dict = {"legs": {}}
    t_phase = time.perf_counter()
    pipeline.run_fit, train_cli.build_model = counted_fit, counted_build
    for c in counters:
        c.launches = 0
    try:
        for task, max_stage in PIPELINE_LEGS:
            leg_dir = os.path.join(workdir, task)
            os.makedirs(leg_dir)
            os.chdir(leg_dir)
            first = len(fits)
            t0 = time.perf_counter()
            records = pipeline.main(["--task", task, "--max-stage", str(max_stage)]
                                    + PIPELINE_FLAGS)
            leg_s = time.perf_counter() - t0
            leg_fits = fits[first:]
            best = None
            if task != "multitask":
                (a, sa), (b, sb) = ((r["loss"], r["best_score"]) for r in records[:2])
                best = pipeline.winner(a, b, sa, sb) if max_stage >= 2 else None
            want = [(task, m, l) for m, l in pipeline.plan(task, max_stage, None, best)]
            configs = _exp_configs(leg_dir)
            got = [(c["task"], c["model"], c["loss"]) for c in configs]
            tables = sorted(os.listdir(os.path.join(leg_dir, "run", "tables")))
            rows = 0
            if "all_runs.csv" in tables:
                with open(os.path.join(leg_dir, "run", "tables", "all_runs.csv")) as f:
                    rows = len(f.read().strip().splitlines()) - 1
            leg = {"fits": len(leg_fits), "seconds": leg_s, "winner": best, "tables": tables,
                   "all_runs_rows": rows,
                   "fit_seconds": [round(f["seconds"], 2) for f in leg_fits]}
            print(f"pipeline[{task}] " + json.dumps(leg), flush=True)
            f32 = all(c["amp"] is False and c["device"] == "cuda" for c in configs)
            want_rows = 0 if task == "multitask" else len(want)
            if (got != want or len(leg_fits) != len(want) or not f32 or rows != want_rows
                    or (task == "multitask") != (tables == [])):
                raise AssertionError(f"pipeline leg {task}: fits {got} != {want}, f32 {f32}, "
                                     f"tables {tables} with {rows} rows")
            out["legs"][task] = leg
        for fit in fits:
            _check_fit_launches(fit)
        if any(set(p) - set(TF32X3_PATHS) for p in paths):
            raise AssertionError(f"pipeline: square conv sites off {TF32X3_PATHS} in f32: {paths}")
    finally:
        pipeline.run_fit, train_cli.build_model = real_fit, real_build
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    totals = {c.__name__: c.launches for c in counters}
    if not all(totals[k] > 0 for k in ("upsample2x", "upsample2x_backward", "conv3x3_bias_relu",
                                       "conv3x3_same", "conv3x3_dgrad")):
        raise AssertionError(f"pipeline: a kernel of the f32 path was not launched: {totals}")
    out.update(launches=totals, seconds=time.perf_counter() - t_phase,
               fits=[{k: f[k] for k in ("model", "loss", "seconds", "launches", "forwards")}
                     for f in fits])
    print("pipeline_fits " + json.dumps(
        [(f["model"], f["loss"], round(f["seconds"], 2)) for f in fits]), flush=True)
    return out


def study_phase(counters) -> dict:
    """Phase 15: one seed of the accuracy study's bf16 resnet + Lovasz arm for 2 epochs.

    ``scripts/torch_parity_study.py`` writes its data tree (parquet where
    ``datasets`` is installed, else VOC), checks that the train CLI opens it
    and not the synthetic fallback, trains, and writes the JSON entry; the
    entry must hold a finite test IoU, and the kernels must have run.
    """
    import importlib.util
    import math

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_parity_study.py")
    spec = importlib.util.spec_from_file_location("torch_parity_study", path)
    study = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = study  # dataclasses look their module up there
    spec.loader.exec_module(study)
    workdir = tempfile.mkdtemp(prefix="study-")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        results = study.main(["--arms", STUDY_ARM, "--seeds", "0", "--epochs", str(STUDY_EPOCHS),
                              "--data", os.path.join(workdir, "data"),
                              "--out", os.path.join(workdir, "parity.json"),
                              "--workdir", os.path.join(workdir, "runs")])
        with open(os.path.join(workdir, "parity.json")) as f:
            written = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    run = written["arms"][STUDY_ARM]["by_seed"]["0"]
    out = {"format": written["data"]["format"], "run": run, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print("study " + json.dumps(out), flush=True)
    if (not math.isfinite(run["IoU"]) or run["amp"] is not True
            or results["arms"][STUDY_ARM]["by_seed"]["0"] != run
            or not all(launches[k] > 0 for k in ("upsample2x", "upsample2x_backward",
                                                 "conv3x3_bias_relu", "conv3x3_dgrad"))):
        raise AssertionError(f"study leg: {out}")
    return out


# Phase 16, the mesh's space axis: a 1x2 mesh splits each 512^2 image's
# rows in two. 16a: the kernels' halo-padded (conv) and band (upsample)
# modes at unet_resnet50's 11 sites, each shard against its plain version
# (phase 2's tolerances) and the shards together against the unsplit kernel:
# forward bit for bit (every output row is the unsplit kernel's own sum);
# backward, the two shards' partial gradients of a halo row are each
# rounded to the type before they are added, so within one more rounding:
# 2^-7 of the largest value in bf16, phase 2's f32 rule in f32. 16b: two
# gloo ranks on the one card against one process; the f32 SGD step to
# 12b's rule, the bf16 steps' first loss to 11b's rtol 1e-3, eval counts
# exactly in f32 (TF32 off). In bf16 cuDNN picks its kernels by shape, and
# a band's convs (H padding 0, fewer rows) round their sums otherwise than
# the whole image's; through ~50 bf16 layers that moves the logits by about
# what one bf16 rounding of the input does, and a logit near 0 changes
# sign. So the bf16 eval is held, as phase 6 holds f32 gradients, to 4x the
# floor measured in the same run: the one-process logits with the input
# moved by one bf16 ulp (2^-8) either way; the pixels whose prediction
# changes, and the logits' largest difference as a share of their largest
# value. 16c: four cards (--multi-card-only).
SPACE_SPLIT = 2
SPACE_STEPS = 6  # 16b's bf16 train steps per rank, after one warm-up step
SPACE_PROFILED_STEPS = 2  # then these under the profiler: the card's busy ms per step
TOL_SPACE_BWD_BF16 = 2.0 ** -7
BF16_ULP = 2.0 ** -8


def _space_shards(h: int):
    """(shard, own rows, input rows with the halo, conv pads) of a 2-way split of ``h`` rows."""
    b = h // SPACE_SPLIT
    return [(0, slice(0, b), slice(0, b + 1), (1, 0)),
            (1, slice(b, h), slice(b - 1, h), (0, 1))]


def _space_row(prefix, kernel, site, s, path, dtype, run, plain, library, nbytes, flops, shape,
               count, sites_of, flipped=None, pad=None):
    """One timed row of a shard; shard 0's counts in the pass of one rank, shard 1's are held only.

    ``pad``: the conv's H pads of the launch (its ``shape`` is the launch's input).
    """
    shapes = {"shape": shape, "count": count if s == 0 else 0, "sites_of": sites_of, "shard": s}
    if pad is not None:
        shapes["pad"] = list(pad)
    return measure_site(prefix, kernel, f"{site}.shard{s}", path, dtype, run, plain,
                        library, nbytes, flops, shapes, flipped=flipped)


@torch.no_grad()
def space_sites(gen: torch.Generator, prefix: str, conv_sites, up_sites, fused: bool,
                align_corners: bool, sites_of: str) -> tuple[list[dict], dict]:
    """The conv's halo-padded and the upsample's band modes at 512^2, batch 8, bf16 and f32,
    each site's rows split in two (phases 16a and 17a).

    ``conv_sites``: (site, C, H, sites of that shape per step); the conv is the
    fused one (bias, ReLU) with ``fused``, else the bias-free ``conv3x3_same``;
    its dgrad is the same kernel either way. ``up_sites``: (site, C, H_in,
    skip channels before its output in the cat). Returns (the timed rows, the
    shards-against-unsplit differences by site). The conv's library yardstick
    is ``F.conv2d`` with padding (0, 1) on the same halo-padded input (TF32
    off), dgrad's cuDNN's on the band's own rows, the upsample's
    ``F.interpolate`` of the band's input and its backward on the band's rows.
    """
    from unet_embroidery_seg_torch.ops import conv3x3 as C
    from unet_embroidery_seg_torch.ops import upsample as U
    from unet_embroidery_seg_torch.ops.resize import band_input_rows

    dev, cl = torch.device("cuda"), torch.channels_last
    rows, unsplit = [], {}
    torch.backends.cudnn.allow_tf32 = False

    def row(*args, flipped=None, pad=None):
        rows.append(_space_row(prefix, *args, sites_of, flipped, pad))

    for dtype in (torch.bfloat16, torch.float32):
        tag = "" if dtype == torch.bfloat16 else ".f32"
        for site, c, h, count in conv_sites:
            x = torch.relu(torch.randn(BATCH, c, h, h, generator=gen)).to(dev, dtype)
            x = x.contiguous(memory_format=cl)
            g = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype).contiguous(
                memory_format=cl)
            w = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(dev)
            w = w.contiguous(memory_format=cl)  # as the models hold it
            b = (0.1 * torch.randn(c, generator=gen)).to(dev)
            wd, bd = w.to(dtype), b.to(dtype)
            packed = C.pack_conv3x3_grad(w, dtype)  # the forward's, with grad on
            path, es = C.conv3x3_path(c, dtype), x.element_size()
            if fused:
                conv = lambda xs, pad=(1, 1): C.conv3x3_bias_relu(xs, w, b, pad)  # noqa: E731
                conv_plain = lambda xs, pad: C.conv3x3_bias_relu_plain(xs, w, b, pad)  # noqa: E731
                library = lambda xs: F.conv2d(xs, wd, bd, padding=(0, 1))  # noqa: E731
            else:
                conv = lambda xs, pad=(1, 1): C.conv3x3_same(xs, w, pad)  # noqa: E731
                conv_plain = lambda xs, pad: C.conv3x3_same_plain(xs, w, pad)  # noqa: E731
                library = lambda xs: F.conv2d(xs, wd, padding=(0, 1))  # noqa: E731
            want_y, want_dx = conv(x), C.conv3x3_dgrad(g, w, C.SAME, packed)
            got_y, got_dx = [], torch.zeros(want_dx.shape, device=dev)
            for s, own, halo_rows, pad in _space_shards(h):
                xs = x[:, :, halo_rows].contiguous(memory_format=cl)
                gs = g[:, :, own].contiguous(memory_format=cl)
                flops = 2.0 * 9 * c * c * BATCH * (h // 2) * h
                row("conv3x3_same", site + tag, s, path, dtype,
                    lambda xs=xs, pad=pad: conv(xs, pad),
                    lambda xs=xs, pad=pad: conv_plain(xs, pad),
                    lambda xs=xs: library(xs),
                    (xs.numel() + gs.numel() + 9 * c * c) * es + (4 * c if fused else 0), flops,
                    list(xs.shape), count, pad=pad)
                dp = C.dgrad_pad(pad)
                row("conv3x3_dgrad", site + tag, s, path, dtype,
                    lambda gs=gs, dp=dp: C.conv3x3_dgrad(gs, w, dp, packed),
                    lambda gs=gs, dp=dp: C.conv3x3_dgrad_plain(gs, w, dp),
                    lambda gs=gs: torch.nn.grad.conv2d_input(gs.shape, wd, gs, padding=1),
                    (xs.numel() + gs.numel() + 9 * c * c) * es, flops, list(gs.shape), count,
                    flipped=_flipped_dgrad(gs, w, dp, packed), pad=dp)
                got_y.append(conv(xs, pad))
                got_dx[:, :, halo_rows] += C.conv3x3_dgrad(gs, w, dp, packed).float()
            unsplit[f"conv3x3_same:{site}{tag}"] = (torch.cat(got_y, 2).float()
                                                     - want_y.float()).abs().max().item()
            unsplit[f"conv3x3_dgrad:{site}{tag}"] = ((got_dx - want_dx.float()).abs().max().item()
                                                      / want_dx.float().abs().max().item())
        ac = align_corners
        for site, c, h, skip in up_sites:
            x = torch.randn(BATCH, c, h, h, generator=gen).to(dev, dtype).contiguous(
                memory_format=cl)
            full_g = torch.randn(BATCH, skip + c, 2 * h, 2 * h, generator=gen)
            g = full_g.to(dev, dtype).contiguous(memory_format=cl)[:, skip:]
            es = x.element_size()
            want_y, want_dx = U.upsample2x(x, ac), U.upsample2x_backward(g, ac)
            got_y, got_dx = [], torch.zeros(want_dx.shape, device=dev)
            for s, own, _, _ in _space_shards(h):
                band = (h, own.start, own.stop)
                first, n = band_input_rows(band)
                xs = x[:, :, first:first + n].contiguous(memory_format=cl)
                gs = g[:, :, 2 * own.start:2 * own.stop]  # the cat slice's rows, read in place
                out_elems = BATCH * c * 2 * (h // 2) * 2 * h
                row("upsample2x", site + tag, s, "staged, band", dtype,
                    lambda xs=xs, band=band: U.upsample2x(xs, ac, band),
                    lambda xs=xs, band=band: U.upsample2x_plain(xs, ac, band),
                    lambda xs=xs: F.interpolate(xs, scale_factor=2, mode="bilinear",
                                                align_corners=ac),
                    (xs.numel() + out_elems) * es, 9.0 * out_elems, list(xs.shape), 1)
                row("upsample2x_backward", site + tag, s,
                    "staged, band, cat slice" if skip else "staged, band", dtype,
                    lambda gs=gs, band=band: U.upsample2x_backward(gs, ac, band),
                    lambda gs=gs, band=band: U.upsample2x_backward_plain(gs, ac, band),
                    lambda gs=gs: torch.ops.aten.upsample_bilinear2d_backward(
                        gs, [gs.shape[2], 2 * h], [BATCH, c, gs.shape[2] // 2, h], ac),
                    (xs.numel() + out_elems) * es, 8.0 * out_elems, list(gs.shape), 1)
                got_y.append(U.upsample2x(xs, ac, band))
                got_dx[:, :, first:first + n] += U.upsample2x_backward(gs, ac, band).float()
            unsplit[f"upsample2x:{site}{tag}"] = (torch.cat(got_y, 2).float()
                                                   - want_y.float()).abs().max().item()
            unsplit[f"upsample2x_backward:{site}{tag}"] = (
                (got_dx - want_dx.float()).abs().max().item()
                / want_dx.float().abs().max().item())
        torch.cuda.empty_cache()
    print(f"{prefix}_unsplit " + json.dumps(unsplit), flush=True)
    for key, err in unsplit.items():
        kernel = key.split(":")[0]
        tol = 0.0 if kernel in ("conv3x3_same", "upsample2x") else (
            TOL_SPACE_BWD_BF16 if not key.endswith(".f32") else TOL_F32[kernel])
        if not err <= tol:
            raise AssertionError(f"space axis: {key} shards against the unsplit kernel: "
                                 f"{err} > {tol}")
    return rows, unsplit


def check_space_sites(gen: torch.Generator) -> tuple[list[dict], dict]:
    """16a: the halo and band modes at unet_resnet50's 11 sites (``space_sites``)."""
    return space_sites(gen, "space_site", [(n, c, h, 1) for n, c, h in DGRAD_SITES],
                       UPSAMPLE_BWD_SITES, fused=True, align_corners=True,
                       sites_of="unet_resnet50, 1x2")


def _space_step_run(mesh, counters, amp: bool, steps: int, profile: bool = False) -> dict:
    """unet_resnet50 (seed 0) Lovasz train steps at 512^2, batch 8, on ``mesh`` (None: one process).

    First one eval step's counts and the eval forward's logits (grad off,
    the seeded weights: both sides read the same; the logits under
    ``logits``, on the CPU; one process also gives ``logits_moved``, with
    the input moved by one bf16 ulp up and down), then one warm-up step,
    then ``steps`` steps with the counters (and the halo exchange's) zeroed
    just before and read just after, CUDA events per step and the peak
    memory; with ``profile``, ``SPACE_PROFILED_STEPS`` more under the
    profiler: the card's busy ms per step and its kernel groups.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_train_batch
    from unet_embroidery_seg_torch.engine.steps import (
        make_binary_eval_step,
        make_binary_train_step,
    )
    from unet_embroidery_seg_torch.models import build_model
    from unet_embroidery_seg_torch.ops import schedules
    from unet_embroidery_seg_torch.parallel import halo
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    device = torch.device("cuda") if mesh is None else mesh.device
    model = build_model("unet_resnet50", 2, diff_head=True,
                        generator=torch.Generator().manual_seed(0), device=device)
    opt = schedules.make_train_optimizer(model.parameters(), TRAIN_LR)
    group, space = (None, None) if mesh is None else (mesh.group, halo.space_axis(mesh))
    step = make_binary_train_step(model, opt, "lovasz_hinge", None, amp=amp, group=group,
                                  space=space)
    batch = seeded_train_batch(BATCH, TRAIN_SIZE, seed=0)
    if mesh is not None:
        batch = mesh_lib.shard_batch_arrays(mesh, *batch)
    evaluate = make_binary_eval_step(model, "lovasz_hinge", None, amp=amp, group=group,
                                     space=space)
    eval_counts = evaluate(*batch)[1].tolist()
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp):
        x = torch.as_tensor(batch[0]).to(device).permute(0, 3, 1, 2)
        logits = model(x).float().cpu()
        moved = ([model(x * scale).float().cpu() for scale in (1 + BF16_ULP, 1 - BF16_ULP)]
                 if mesh is None else None)
    losses = [float(step(*batch))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for c in counters:
        c.launches = c.halo_launches = 0
    halo.SpaceAxis.collectives = 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    out = []
    for k in range(steps):
        out.append(step(*batch))
        marks[k + 1].record()
    losses += [float(v) for v in out]
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    result = {"losses": losses, "step_ms_median": statistics.median(step_ms),
              "step_ms": step_ms, "step_ms_method": "cuda_events",
              "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
              "launches": {c.__name__: c.launches for c in counters},
              "halo_launches": {c.__name__: c.halo_launches for c in counters},
              "exchange_calls_per_step": halo.SpaceAxis.collectives / steps,
              "eval_counts": eval_counts,
              "logits": logits, "logits_moved": moved}
    if profile:
        from unet_embroidery_seg_torch.utils.timing import device_ms_by_group

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(SPACE_PROFILED_STEPS):
                step(*batch)
            torch.cuda.synchronize()
        by_group, _ = device_ms_by_group(prof, SPACE_PROFILED_STEPS)
        result["device_busy_ms_per_step"] = sum(by_group.values())
        result["device_ms_by_group"] = by_group
    del model, opt, step
    torch.cuda.empty_cache()
    return result


def _space_rank(rank: int, devices: list, out_dir: str) -> None:
    """One rank of 16b (gloo, two ranks on one card) or 16c (NCCL): the 1x2 mesh's steps.

    The f32 eval counts and SGD step (TF32 off; its state dict saved for the
    parent), then the bf16 eval and steps of ``_space_step_run``; results to
    ``out_dir/space_rank<r>.json``.
    """
    import torch.distributed as dist

    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward
    from unet_embroidery_seg_torch.parallel import halo
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(1, SPACE_SPLIT, devices)
    counters = [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad]
    result = {"rank": rank, "device": str(mesh.device), "backend": dist.get_backend()}
    from unet_embroidery_seg_torch.engine.steps import make_binary_eval_step

    model, batch = _sgd_model_and_batch(mesh.device)
    batch = mesh_lib.shard_batch_arrays(mesh, *batch)
    space = halo.space_axis(mesh)
    result["f32_eval_counts"] = make_binary_eval_step(
        model, "lovasz_hinge", None, amp=False, group=mesh.group, space=space)(*batch)[1].tolist()
    for c in counters:
        c.halo_launches = 0
    result["sgd_loss"] = _sgd_step(model, batch, mesh.group, space)
    result["sgd_halo_launches"] = {c.__name__: c.halo_launches for c in counters}
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, f"space_rank{rank}_sgd.pt"))
    del model
    torch.cuda.empty_cache()
    result["bf16"] = _space_step_run(mesh, counters, True, SPACE_STEPS, profile=True)
    result["bf16"].pop("logits_moved")
    torch.save(result["bf16"].pop("logits"), os.path.join(out_dir, f"space_rank{rank}_logits.pt"))
    with open(os.path.join(out_dir, f"space_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _run_space_ranks(devices: list, backend: str) -> tuple[list[dict], list[dict], float]:
    """``_space_rank`` on two new processes: (their results, their SGD states, seconds).

    Each result's bf16 ``logits`` are the rank's band of the eval logits.
    """
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    out_dir = tempfile.mkdtemp(prefix="space-ranks-")
    t0 = time.perf_counter()
    try:
        mesh_lib.launch_local(_space_rank, SPACE_SPLIT, (devices, out_dir), backend=backend,
                              timeout_s=600)
        seconds = time.perf_counter() - t0
        ranks, states = [], []
        for r in range(SPACE_SPLIT):
            with open(os.path.join(out_dir, f"space_rank{r}.json")) as f:
                ranks.append(json.load(f))
            states.append(torch.load(os.path.join(out_dir, f"space_rank{r}_sgd.pt"),
                                     weights_only=True))
            ranks[-1]["bf16"]["logits"] = torch.load(
                os.path.join(out_dir, f"space_rank{r}_logits.pt"), weights_only=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return ranks, states, seconds


def space_one_card(counters) -> dict:
    """16b: a 1x2 mesh of two gloo ranks on the one card against one process.

    One process first: the f32 SGD step three times (input as is, and moved
    by one ulp either way: the noise floor, as 12b), its eval counts, and
    ``SPACE_STEPS`` bf16 Lovasz steps with launches, ms/step and peak
    memory. Then the two ranks, each on its band of every image's rows.
    """
    from unet_embroidery_seg_torch.engine.steps import make_binary_eval_step

    init, batch = _sgd_model_and_batch("cpu")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    one = {}
    for run, scale in (("one", 1.0), ("one_up", 1 + 2.0 ** -23), ("one_down", 1 - 2.0 ** -23)):
        model, _ = _sgd_model_and_batch("cuda")
        if run == "one":
            one_f32_counts = make_binary_eval_step(model, "lovasz_hinge", None, amp=False)(
                *batch)[1].tolist()
        images, pngs, sm = batch
        loss = _sgd_step(model, (images * np.float32(scale), pngs, sm))
        one[run] = (loss, {k: v.cpu() for k, v in model.state_dict().items()})
        del model
    torch.cuda.empty_cache()
    one_bf16 = _space_step_run(None, counters, True, SPACE_STEPS, profile=True)
    ranks, states, seconds = _run_space_ranks([torch.device("cuda", 0)] * SPACE_SPLIT, "gloo")
    bf16 = [r["bf16"] for r in ranks]
    want_logits = one_bf16.pop("logits")
    got_logits = torch.cat([r.pop("logits") for r in bf16], 1)  # (N, H, W): bands of H

    def apart(a):  # (pixels whose prediction differs, largest difference / largest logit)
        return (int(((a > 0) != (want_logits > 0)).sum()),
                ((a - want_logits).abs().max() / want_logits.abs().max()).item())

    flips, logit_diff = apart(got_logits)
    floors = [apart(a) for a in one_bf16.pop("logits_moved")]
    floor_flips, floor_diff = max(f[0] for f in floors), max(f[1] for f in floors)
    result = {"mesh": "1x2", "backend": "gloo", "devices": "cuda:0 x2", "seconds": seconds,
              "sgd": {"lr": DDP_LR_SGD, "loss_space": ranks[0]["sgd_loss"],
                      "loss_one_process": one["one"][0],
                      "loss_rel_diff": abs(ranks[0]["sgd_loss"] - one["one"][0])
                      / abs(one["one"][0]),
                      "ranks_bit_equal": all(torch.equal(states[0][k], states[1][k])
                                             for k in states[0]),
                      "halo_launches_per_rank": [r["sgd_halo_launches"] for r in ranks]},
              "f32_eval_counts": {"space": [r["f32_eval_counts"] for r in ranks],
                                  "one_process": one_f32_counts},
              "bf16": {"steps": SPACE_STEPS, "losses_space": bf16[0]["losses"],
                       "losses_one_process": one_bf16["losses"],
                       "first_loss_rel_diff": abs(bf16[0]["losses"][0] - one_bf16["losses"][0])
                       / abs(one_bf16["losses"][0]),
                       "launches_per_rank": [r["launches"] for r in bf16],
                       "halo_launches_per_rank": [r["halo_launches"] for r in bf16],
                       "exchange_calls_per_step_per_rank": [r["exchange_calls_per_step"]
                                                            for r in bf16],
                       "step_ms_median_per_rank": [r["step_ms_median"] for r in bf16],
                       "step_ms_per_rank": [r["step_ms"] for r in bf16],
                       "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in bf16],
                       "busy_ms_per_step_per_rank": [r["device_busy_ms_per_step"] for r in bf16],
                       "device_ms_by_group_rank0": bf16[0]["device_ms_by_group"],
                       "one_process_busy_ms_per_step": one_bf16["device_busy_ms_per_step"],
                       "one_process_device_ms_by_group": one_bf16["device_ms_by_group"],
                       "one_process_step_ms_median": one_bf16["step_ms_median"],
                       "one_process_peak_mem_gb": one_bf16["peak_mem_gb"],
                       "one_process_launches": one_bf16["launches"],
                       "eval_counts_space": [r["eval_counts"] for r in bf16],
                       "eval_counts_one_process": one_bf16["eval_counts"],
                       "eval_flipped_pixels": flips,
                       "eval_flipped_share": flips / want_logits.numel(),
                       "eval_logit_rel_diff": logit_diff,
                       "eval_floor_flipped_pixels": floor_flips,
                       "eval_floor_logit_rel_diff": floor_diff}}
    entries, ok = _update_rule(states[0], one["one"][1], one["one_up"][1], one["one_down"][1],
                               init)
    result["sgd"].update(entries)
    ok = (ok and result["sgd"]["ranks_bit_equal"]
          and result["sgd"]["loss_rel_diff"] <= TOL_DDP_LOSS_F32)
    want = {k: v * SPACE_STEPS for k, v in RESNET_PER_STEP.items() if k in bf16[0]["launches"]}
    print("space_one_card " + json.dumps(result), flush=True)
    ok = (ok and all(r["launches"] == want and r["halo_launches"] == want for r in bf16)
          and one_bf16["launches"] == want and not any(one_bf16["halo_launches"].values())
          and all(c == one_f32_counts for c in result["f32_eval_counts"]["space"])
          and bf16[0]["eval_counts"] == bf16[1]["eval_counts"]
          and flips <= TOL_TRAIN_NOISE_FACTOR * floor_flips
          and logit_diff <= TOL_TRAIN_NOISE_FACTOR * floor_diff
          and bf16[0]["losses"] == bf16[1]["losses"]
          and result["bf16"]["first_loss_rel_diff"] <= TOL_RESIDENT_LOSS
          and np.isfinite(bf16[0]["losses"]).all())
    if not ok:
        raise AssertionError(f"space axis, two ranks on one card against one process: {result}")
    return result


def space_cli(extra: list[str]) -> dict:
    """The train CLI on a 2x2 mesh of four cards over NCCL (16c, 17c), in a subprocess.

    512^2, batch 8, one epoch of 4 steps on ``synthetic:16``, plus ``extra``
    flags; ``ok`` when it exits 0 having written one ``expN`` with its
    ``summary.json``.
    """
    workdir = tempfile.mkdtemp(prefix="space-cli-")
    cmd = [sys.executable, "-m", "unet_embroidery_seg_torch.train", "--data-path",
           "synthetic:16", "--input-size", str(TRAIN_SIZE), "--batch-size", str(BATCH),
           "--epochs", "1", "--max-train-batches", "4", "--max-val-batches", "1",
           "--max-test-batches", "1", "--mesh-data", "2", "--mesh-space", "2",
           "--no-export-vis", "--ckpt-every", "0", *extra]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, stderr = proc.communicate()
    cli_s = time.perf_counter() - t0
    runs = sorted(os.listdir(os.path.join(workdir, "run", "train"))) if proc.returncode == 0 \
        else []
    files = sorted(os.listdir(os.path.join(workdir, "run", "train", "exp"))) if runs else []
    shutil.rmtree(workdir, ignore_errors=True)
    return {"flags": extra, "returncode": proc.returncode, "seconds": cli_s, "runs": runs,
            "files": files, "stderr_tail": stderr[-4000:],
            "ok": proc.returncode == 0 and runs == ["exp"] and "summary.json" in files}


def space_four_cards(one_card: dict | None = None) -> dict:
    """16c: the train CLI with --mesh-data 2 --mesh-space 2 over NCCL, and a 1x2 step on two cards.

    With fewer than four cards it says why it did not run. ``one_card``:
    16b's result, for the one-process bf16 losses the 1x2 step is held to.
    """
    n = torch.cuda.device_count()
    if n < 4:
        reason = (f"phase 16c not run: this machine has {n} CUDA card(s), and a 2x2 mesh over "
                  "NCCL needs four")
        print(reason, flush=True)
        return {"ran": False, "reason": reason}
    ranks, _, seconds = _run_space_ranks([torch.device("cuda", i) for i in range(SPACE_SPLIT)],
                                         "nccl")
    cli = space_cli([])
    bf16 = [r["bf16"] for r in ranks]
    for r in bf16:
        del r["logits"]
    result = {"ran": True, "cards": n, "backend": "nccl", "seconds": seconds,
              "step_1x2": {"losses": bf16[0]["losses"],
                           "step_ms_median_per_rank": [r["step_ms_median"] for r in bf16],
                           "launches_per_rank": [r["launches"] for r in bf16],
                           "halo_launches_per_rank": [r["halo_launches"] for r in bf16],
                           "exchange_calls_per_step_per_rank": [
                               r["exchange_calls_per_step"] for r in bf16],
                           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in bf16],
                           "busy_ms_per_step_per_rank": [r["device_busy_ms_per_step"]
                                                         for r in bf16],
                           "device_ms_by_group_rank0": bf16[0]["device_ms_by_group"],
                           "eval_counts_per_rank": [r["eval_counts"] for r in bf16]},
              "cli": cli}
    if one_card is not None:
        want = one_card["bf16"]["losses_one_process"]
        result["step_1x2"]["first_loss_rel_diff"] = abs(bf16[0]["losses"][0] - want[0]) / abs(
            want[0])
    print("space_four_cards " + json.dumps(result), flush=True)
    if (not cli["ok"] or not np.isfinite(bf16[0]["losses"]).all()
            or result["step_1x2"].get("first_loss_rel_diff", 0.0) > TOL_RESIDENT_LOSS):
        raise AssertionError(f"space axis on four cards: {result}")
    return result


def space_phase(counters) -> dict:
    """Phase 16: 16a's kernel modes, 16b's two ranks on one card, 16c's four cards."""
    t0 = time.perf_counter()
    rows, unsplit = check_space_sites(torch.Generator().manual_seed(16))
    out = {"sites": rows, "unsplit": unsplit, "one_card": space_one_card(counters)}
    out["four_cards"] = space_four_cards(out["one_card"])
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 17, the space axis for the other families and tasks, a 1x2 mesh as
# phase 16. 17a: phase 16a at the families' sites (512^2, batch 8): the
# bias-free conv's halo mode at its 5 DoubleConv shapes (9 sites) and the
# align_corners=False band upsample at its 4 sites, forward and backward,
# bf16 and f32, with 16a's tolerances. 17b: two gloo ranks on the one card
# against one process, for each run of ``FAMILY_SPACE_RUNS``: one f32 SGD step
# (TF32 off) to 12b's rule (the loss to 1e-5, each update to 4x the one-ulp
# floor), the f32 eval results exactly (seeded weights: a one-process
# prediction and its band's agree), then a few bf16 Adam steps with every
# launch in its halo or band mode, ms/step and peak memory per rank beside
# one process's. multitask_unet's dropout is on: one data index draws one
# process's mask. 17c (``--multi-card-only``, four cards): the train CLI on
# a 2x2 mesh for unet_plain multiclass and multitask_unet.
FAMILY_SPACE_RUNS = (("unet_plain", "binary", "bce"), ("attention_unet", "binary", "bce"),
                     ("dualdense_unet", "binary", "bce"), ("unet_plain", "multiclass", "ce"),
                     ("multitask_unet", "multitask", "bce"))
FAMILY_SPACE_BF16_STEPS = 3  # after one warm-up step
FAMILY_SPACE_SEED = 17
FAMILY_SPACE_CLI = (["--task", "multiclass", "--model", "unet_plain", "--loss", "ce"],
                    ["--task", "multitask", "--model", "multitask_unet", "--loss", "bce"])


def family_per_step(name: str) -> dict:
    """A family's kernel launches per train step: its forward's, each with its backward."""
    f = FAMILY_FORWARD_LAUNCHES[name]
    return {**f, "upsample2x_backward": f["upsample2x"], "conv3x3_dgrad": f["conv3x3_same"]}


def _family_space_model(spec: tuple, device):
    """17b's run ``spec``'s full-width model, seeded (``FAMILY_SPACE_SEED``), on ``device``."""
    from unet_embroidery_seg_torch.models import build_model

    name, task, _ = spec
    gen = torch.Generator().manual_seed(FAMILY_SPACE_SEED)
    if task == "multitask":
        return build_model("multitask_unet", 1, generator=gen, device=device)
    return build_model(name, 2 if task == "binary" else MC_CLASSES, diff_head=task == "binary",
                       generator=gen, device=device)


def _family_space_step(model, task: str, loss: str, opt, amp: bool, group, space):
    """The task's train step, returning the (total) loss tensor."""
    from unet_embroidery_seg_torch.engine import steps

    kw = {"amp": amp, "group": group, "space": space}
    if task == "binary":
        return steps.make_binary_train_step(model, opt, loss, None, **kw)
    if task == "multiclass":
        return steps.make_multiclass_train_step(model, opt, MC_CLASSES, use_dice=True, **kw)
    step = steps.make_multitask_train_step(model, opt, loss, 1.0, None, **kw)
    return lambda *batch: step(*batch)[0][0]


def _family_space_eval(model, task: str, loss: str, batch, group, space) -> dict:
    """The task's f32 eval results: binary counts; multiclass per-batch metrics (from integer
    tables) and per-sample sums; multitask seg counts and class confusion."""
    from unet_embroidery_seg_torch.engine import steps

    kw = {"amp": False, "group": group, "space": space}
    if task == "binary":
        return {"counts": steps.make_binary_eval_step(model, loss, None, **kw)(*batch)[1].tolist()}
    if task == "multiclass":
        _, m = steps.make_multiclass_eval_step(model, MC_CLASSES, **kw)(*batch)
        _, sums, n_valid = steps.make_multiclass_persample_eval_step(model, MC_CLASSES, **kw)(
            *batch)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "per_sample": {"n_valid": float(n_valid), **{k: float(v) for k, v in sums.items()}}}
    _, seg_counts, confusion = steps.make_multitask_eval_step(model, loss, **kw)(*batch)
    return {"seg_counts": seg_counts.tolist(), "confusion": confusion.tolist()}


def _family_space_case(spec: tuple, mesh, counters, floors: bool) -> tuple[dict, list[dict]]:
    """17b's run ``spec`` on ``mesh`` (None: one process): (results, f32 SGD states on the CPU).

    The f32 eval and SGD step from the seeded weights (``floors``: the SGD
    step again with the input moved one ulp up and down), then
    ``FAMILY_SPACE_BF16_STEPS`` timed bf16 Adam steps after a warm-up one,
    the counters zeroed just before them and read just after.
    """
    from unet_embroidery_seg_torch.data.synthetic import seeded_task_batch
    from unet_embroidery_seg_torch.engine.resident import rank_seed, seed_default_generator
    from unet_embroidery_seg_torch.ops import schedules
    from unet_embroidery_seg_torch.parallel import halo
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    name, task, loss = spec
    device = torch.device("cuda") if mesh is None else mesh.device
    group, space = (None, None) if mesh is None else (mesh.group, halo.space_axis(mesh))
    model = _family_space_model(spec, device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = seeded_task_batch(BATCH, TRAIN_SIZE, FAMILY_SPACE_SEED, task, MC_CLASSES)
    if mesh is not None:
        batch = mesh_lib.shard_batch_arrays(mesh, *batch)

    def run_steps(step, n, seed0):
        out = []
        for k in range(n):  # multitask's dropout: the train CLI's seeding
            seed_default_generator(device, rank_seed(seed0 + k, mesh))
            out.append(step(*batch))
        return out

    result = {"f32_eval": _family_space_eval(model, task, loss, batch, group, space)}
    states = []
    for scale in ((1.0, 1 + 2.0 ** -23, 1 - 2.0 ** -23) if floors else (1.0,)):
        model.load_state_dict(init)
        for c in counters:
            c.halo_launches = 0
        step = _family_space_step(model, task, loss, torch.optim.SGD(model.parameters(),
                                                                     lr=DDP_LR_SGD),
                                  False, group, space)
        images, *rest = batch
        seed_default_generator(device, rank_seed(0, mesh))
        value = float(step(images * np.float32(scale), *rest))
        states.append({k: v.to("cpu", copy=True) for k, v in model.state_dict().items()})
        if scale == 1.0:
            result["sgd_loss"] = value
            result["sgd_halo_launches"] = {c.__name__: c.halo_launches for c in counters}
    model.load_state_dict(init)
    step = _family_space_step(model, task, loss, schedules.make_train_optimizer(
        model.parameters(), TRAIN_LR), True, group, space)
    losses = [float(v) for v in run_steps(step, 1, 100)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for c in counters:
        c.launches = c.halo_launches = 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(FAMILY_SPACE_BF16_STEPS + 1)]
    marks[0].record()
    out = []
    for k in range(FAMILY_SPACE_BF16_STEPS):
        out += run_steps(step, 1, 101 + k)
        marks[k + 1].record()
    losses += [float(v) for v in out]
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    result["bf16"] = {"losses": losses, "step_ms": step_ms,
                      "step_ms_median": statistics.median(step_ms),
                      "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                      "launches": {c.__name__: c.launches for c in counters},
                      "halo_launches": {c.__name__: c.halo_launches for c in counters}}
    del model, step
    torch.cuda.empty_cache()
    return result, states


def _family_space_key(spec: tuple) -> str:
    return f"{spec[0]}.{spec[1]}"


def _family_counters() -> list:
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad, conv3x3_same
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward

    return [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_same, conv3x3_dgrad]


def _family_space_rank(rank: int, devices: list, out_dir: str) -> None:
    """One rank of 17b: every run of ``FAMILY_SPACE_RUNS`` on the 1x2 mesh, to ``out_dir``."""
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(1, SPACE_SPLIT, devices)
    counters = _family_counters()
    results = {}
    for spec in FAMILY_SPACE_RUNS:
        t0 = time.perf_counter()
        key = _family_space_key(spec)
        results[key], states = _family_space_case(spec, mesh, counters, floors=False)
        results[key]["seconds"] = time.perf_counter() - t0
        torch.save(states[0], os.path.join(out_dir, f"{key}.rank{rank}.pt"))
    with open(os.path.join(out_dir, f"families_rank{rank}.json"), "w") as f:
        json.dump(results, f)


def family_space_one_card() -> dict:
    """17b: each run of ``FAMILY_SPACE_RUNS`` on two gloo ranks on the one card against one process.

    One process first (with its f32 floors), then the two ranks in one job,
    every run in turn; then each run's checks (the block comment above).
    """
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _family_counters()
    one, one_states = {}, {}
    for spec in FAMILY_SPACE_RUNS:
        key = _family_space_key(spec)
        one[key], one_states[key] = _family_space_case(spec, None, counters, floors=True)
    out_dir = tempfile.mkdtemp(prefix="family-space-ranks-")
    t0 = time.perf_counter()
    try:
        mesh_lib.launch_local(_family_space_rank, SPACE_SPLIT,
                              ([torch.device("cuda", 0)] * SPACE_SPLIT, out_dir), backend="gloo",
                              timeout_s=900)
        seconds = time.perf_counter() - t0
        ranks, states = [], {}
        for r in range(SPACE_SPLIT):
            with open(os.path.join(out_dir, f"families_rank{r}.json")) as f:
                ranks.append(json.load(f))
        for spec in FAMILY_SPACE_RUNS:
            key = _family_space_key(spec)
            states[key] = [torch.load(os.path.join(out_dir, f"{key}.rank{r}.pt"),
                                      weights_only=True) for r in range(SPACE_SPLIT)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    result, failed = {"mesh": "1x2", "backend": "gloo", "devices": "cuda:0 x2",
                      "ranks_seconds": seconds, "runs": {}}, []
    for spec in FAMILY_SPACE_RUNS:
        key, (name, task, _) = _family_space_key(spec), spec
        mine, ref = [r[key] for r in ranks], one[key]
        ref_state, up, down = one_states[key]
        per_step = RESNET_PER_STEP if task == "multitask" else family_per_step(name)
        want = {k: v * FAMILY_SPACE_BF16_STEPS for k, v in per_step.items()}
        run = {"sgd": {"lr": DDP_LR_SGD, "loss_space": mine[0]["sgd_loss"],
                       "loss_one_process": ref["sgd_loss"],
                       "loss_rel_diff": abs(mine[0]["sgd_loss"] - ref["sgd_loss"])
                       / abs(ref["sgd_loss"]),
                       "ranks_bit_equal": all(torch.equal(states[key][0][k], states[key][1][k])
                                              for k in states[key][0]),
                       "halo_launches_per_rank": [m["sgd_halo_launches"] for m in mine]},
               "f32_eval_space": [m["f32_eval"] for m in mine],
               "f32_eval_one_process": ref["f32_eval"],
               "bf16": {"steps": FAMILY_SPACE_BF16_STEPS,
                        "losses_space": mine[0]["bf16"]["losses"],
                        "losses_one_process": ref["bf16"]["losses"],
                        "launches_per_rank": [m["bf16"]["launches"] for m in mine],
                        "halo_launches_per_rank": [m["bf16"]["halo_launches"] for m in mine],
                        "step_ms_median_per_rank": [m["bf16"]["step_ms_median"] for m in mine],
                        "step_ms_per_rank": [m["bf16"]["step_ms"] for m in mine],
                        "peak_mem_gb_per_rank": [m["bf16"]["peak_mem_gb"] for m in mine],
                        "one_process_step_ms_median": ref["bf16"]["step_ms_median"],
                        "one_process_step_ms": ref["bf16"]["step_ms"],
                        "one_process_peak_mem_gb": ref["bf16"]["peak_mem_gb"],
                        "one_process_launches": ref["bf16"]["launches"]},
               "rank_seconds": [m["seconds"] for m in mine]}
        entries, ok = _update_rule(states[key][0], ref_state, up, down,
                                   _family_space_model(spec, "cpu").state_dict())
        run["sgd"].update(entries)
        ok = (ok and run["sgd"]["ranks_bit_equal"]
              and run["sgd"]["loss_rel_diff"] <= TOL_DDP_LOSS_F32
              and all(e == ref["f32_eval"] for e in run["f32_eval_space"])
              and all(m["bf16"]["launches"] == want and m["bf16"]["halo_launches"] == want
                      for m in mine)
              and ref["bf16"]["launches"] == want
              and not any(ref["bf16"]["halo_launches"].values())
              and mine[0]["bf16"]["losses"] == mine[1]["bf16"]["losses"]
              and np.isfinite(mine[0]["bf16"]["losses"]).all()
              and all(m["sgd_halo_launches"] == {k: v for k, v in per_step.items()}
                      for m in mine))
        run["ok"] = ok
        result["runs"][key] = run
        if not ok:
            failed.append(key)
    print("family_space_one_card " + json.dumps(result), flush=True)
    if failed:
        raise AssertionError(f"space axis, families on two ranks of one card: {failed} failed")
    return result


def family_space_four_cards() -> dict:
    """17c: the train CLI on a 2x2 mesh of four cards for unet_plain multiclass and multitask_unet.

    With fewer than four cards it says why it did not run.
    """
    n = torch.cuda.device_count()
    if n < 4:
        reason = (f"phase 17c not run: this machine has {n} CUDA card(s), and a 2x2 mesh over "
                  "NCCL needs four")
        print(reason, flush=True)
        return {"ran": False, "reason": reason}
    result = {"ran": True, "cards": n, "cli": [space_cli(flags) for flags in FAMILY_SPACE_CLI]}
    print("family_space_four_cards " + json.dumps(result), flush=True)
    if not all(c["ok"] for c in result["cli"]):
        raise AssertionError(f"space axis, families' CLI on four cards: {result}")
    return result


def family_space_phase() -> dict:
    """Phase 17: 17a's kernel modes at the families' sites, 17b, 17c."""
    t0 = time.perf_counter()
    rows, unsplit = space_sites(torch.Generator().manual_seed(17), "family_space_site",
                                FAMILY_DGRAD_SITES, FAMILY_UPSAMPLE_BWD_SITES, fused=False,
                                align_corners=False,
                                sites_of="unet_plain, attention_unet, dualdense_unet, 1x2")
    out = {"sites": rows, "unsplit": unsplit, "sites_seconds": time.perf_counter() - t0}
    out["one_card"] = family_space_one_card()
    out["four_cards"] = family_space_four_cards()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17: {out['seconds']:.1f} s", flush=True)
    return out


# Phase 18, the alternates against their defaults. 18a's bf16 rule: the
# packed tail's distance from the unpacked one, within this factor of the
# unpacked bf16 tail's distance from its own f32 run (both round at every
# op, in other places; measured in the run). 18c: the flat and tree steps'
# parameters after one step on the same gradients within 4 f32 ulps of the
# largest of the value before, after and the update (the update goes
# through seven rounded ops, which the foreach kernels and the arena's
# contract otherwise: measured 2.5 ulps of the update on the H100; an
# update that cancels its value leaves a tiny result with the update's
# rounding; tests/test_torch_flat_adam.py).
TOL_PACKED_BF16_FACTOR = 4.0
# 18a's bf16 dW by norm: two bf16 stages each about the floor (the unpacked
# bf16 dW's distance from its f32 run) from the exact dW lie at most twice
# that apart (the triangle inequality); measured 0.73x the floor.
TOL_PACKED_BF16_DW_NORM_FACTOR = 2.0
TAIL_C, TAIL_H, TAIL_CLASSES = 64, 256, 2
STEM_FEATURES = 64
FLAT_STEP_ULPS = 4
OPT_TIMED_CALLS = 20


def _alternates():
    """``tests/torch_alternates.py``: the JAX package's alternates, kept beside the tests that
    hold them to JAX (none is an option of the port)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_alternates

    return torch_alternates


def _ms_pair(fn) -> dict:
    """Eager ms and graph-replay ms of ``fn``; a capture that does not hold raises.

    ``fn``'s inputs are leaves: a backward that reaches a ``grad_fn`` made
    outside the capture on another stream loses the capture
    (``utils/timing.graph_ms``).
    """
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    eager = event_ms(fn)
    return {"ms": graph_ms(fn, eager), "eager_ms": eager, "ms_method": MS_METHOD}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| over ||b|| (2-norms over every element)."""
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


def packed_tail_check(gen: torch.Generator) -> dict:
    """18a: the packed decoder tail against the unpacked one at unet_resnet50's ``up_conv``."""
    pt = _alternates()
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
    from unet_embroidery_seg_torch.ops.upsample import upsample2x

    dev, c = torch.device("cuda"), TAIL_C
    x0 = torch.relu(torch.randn(BATCH, c, TAIL_H, TAIL_H, generator=gen)).to(dev)
    x0 = x0.contiguous(memory_format=torch.channels_last)
    params = {"w1": torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5),
              "b1": 0.1 * torch.randn(c, generator=gen),
              "w2": torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5),
              "b2": 0.1 * torch.randn(c, generator=gen),
              "wh": torch.randn(TAIL_CLASSES, c, 1, 1, generator=gen) / c ** 0.5,
              "bh": 0.1 * torch.randn(TAIL_CLASSES, generator=gen)}
    params = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
    gy = torch.randn(BATCH, TAIL_CLASSES, 2 * TAIL_H, 2 * TAIL_H, generator=gen).to(dev)

    def unpacked(x):
        y = conv3x3_bias_relu(upsample2x(x, True), params["w1"], params["b1"])
        y = conv3x3_bias_relu(y, params["w2"], params["b2"])
        return F.conv2d(y, params["wh"], params["bh"])

    def packed(x):
        y = F.relu(pt.packed_conv3x3(pt.packed_upsample2x(x, True), params["w1"], params["b1"]))
        y = F.relu(pt.packed_conv3x3(y, params["w2"], params["b2"]))
        return pt.depth_to_space2(pt.packed_conv1x1(y, params["wh"], params["bh"]))

    def exact(x):  # the same stage in float64 with stock ops: the f32 rule's reference
        p64 = {k: v.double() for k, v in params.items()}
        y = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        y = F.relu(F.conv2d(y, p64["w1"], p64["b1"], padding=1))
        y = F.relu(F.conv2d(y, p64["w2"], p64["b2"], padding=1))
        return F.conv2d(y, p64["wh"], p64["bh"])

    def run(tail, x, amp: bool):
        """(forward, forward + backward) of ``tail`` on ``x``; autocast's cast cache off, so a
        CUDA graph can hold the backward's casts."""
        def fwd():
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp, cache_enabled=False):
                return tail(x)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), [x, *params.values()], gy.to(x.dtype))

        return fwd, fwd_bwd

    out, logits = {"shape": [BATCH, c, TAIL_H, TAIL_H], "classes": TAIL_CLASSES}, {}
    # Each dtype's input is a leaf copy: ``x0.to(torch.float32)`` would be x0
    # itself, and requiring grad on it would make the next dtype's input a
    # non-leaf, whose captured backward loses its capture (``_ms_pair``).
    for dtype in (torch.float32, torch.bfloat16):
        key = "f32" if dtype == torch.float32 else "bf16"
        x = x0.to(dtype, copy=True).requires_grad_(True)
        for name, tail in (("packed", packed), ("unpacked", unpacked)):
            fwd, fwd_bwd = run(tail, x, dtype == torch.bfloat16)
            with torch.no_grad():
                logits[key, name] = fwd().float()
                forward = _ms_pair(fwd)
            logits[key, name, "dw1"] = fwd_bwd()[1].float()
            out[f"{key}_{name}"] = {"forward": forward, "forward_backward": _ms_pair(fwd_bwd)}
        out[f"{key}_max_rel_diff"] = _rel(logits[key, "packed"], logits[key, "unpacked"])
        out[f"{key}_dw1_max_rel_diff"] = _rel(logits[key, "packed", "dw1"],
                                              logits[key, "unpacked", "dw1"])
    # The rules' references. f32 dW (2M products a weight, with cancellation,
    # through two ReLU masks): each path's distance from the float64 stage;
    # the packed one within 4x the unpacked one's, plus 1e-4. bf16: the
    # unpacked bf16 tail's distance from its f32 run.
    x64 = x0.double().requires_grad_(True)
    dw1_exact = torch.autograd.grad(exact(x64), [x64, *params.values()], gy.double())[1]
    for name in ("packed", "unpacked"):
        out[f"f32_{name}_dw1_rel_err"] = _rel(logits["f32", name, "dw1"], dw1_exact)
    del x64, dw1_exact
    out["bf16_floor"] = _rel(logits["bf16", "unpacked"], logits["f32", "unpacked"])
    out["bf16_dw1_floor"] = _rel(logits["bf16", "unpacked", "dw1"],
                                 logits["f32", "unpacked", "dw1"])
    # bf16 dW by norm as well, to a factor of 2 (not 4): the max rule's limit,
    # 4x a ~6% floor, is near a typical element's size.
    out["bf16_dw1_norm_rel_diff"] = _rel_norm(logits["bf16", "packed", "dw1"],
                                              logits["bf16", "unpacked", "dw1"])
    out["bf16_dw1_norm_floor"] = _rel_norm(logits["bf16", "unpacked", "dw1"],
                                           logits["f32", "unpacked", "dw1"])
    out["tol_f32"] = TOL_F32["conv3x3_same"]
    out["tol_f32_dw1_err"] = TOL_TRAIN_NOISE_FACTOR * out["f32_unpacked_dw1_rel_err"] + TOL_F32_GRAD
    out["tol_bf16"] = TOL_PACKED_BF16_FACTOR * out["bf16_floor"]
    out["tol_bf16_dw1"] = TOL_PACKED_BF16_FACTOR * out["bf16_dw1_floor"]
    out["tol_bf16_dw1_norm"] = TOL_PACKED_BF16_DW_NORM_FACTOR * out["bf16_dw1_norm_floor"]
    print("alternates_packed_tail " + json.dumps(out), flush=True)
    ok = (out["f32_max_rel_diff"] <= out["tol_f32"]
          and out["f32_packed_dw1_rel_err"] <= out["tol_f32_dw1_err"]
          and out["bf16_max_rel_diff"] <= out["tol_bf16"]
          and out["bf16_dw1_max_rel_diff"] <= out["tol_bf16_dw1"]
          and out["bf16_dw1_norm_rel_diff"] <= out["tol_bf16_dw1_norm"])
    if not ok:
        raise AssertionError(f"packed tail against unpacked: {out}")
    return out


def stem_modes_check(gen: torch.Generator) -> dict:
    """18b: each ``StemConv7x7`` mode against ``direct`` at 512^2, batch 8, bf16 and f32."""
    alt = _alternates()

    dev = torch.device("cuda")
    x = torch.rand(BATCH, 3, TRAIN_SIZE, TRAIN_SIZE, generator=gen).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.randn(STEM_FEATURES, 3, 7, 7, generator=gen) * 0.02
    gy = torch.randn(BATCH, STEM_FEATURES, TRAIN_SIZE // 2, TRAIN_SIZE // 2, generator=gen)
    gy = gy.to(dev).contiguous(memory_format=torch.channels_last)
    out = {"shape": [BATCH, 3, TRAIN_SIZE, TRAIN_SIZE], "features": STEM_FEATURES}
    for dtype in (torch.float32, torch.bfloat16):
        key = "f32" if dtype == torch.float32 else "bf16"
        amp = dtype == torch.bfloat16
        ref = None
        for mode in alt.STEM_MODES:
            stem = alt.StemConv7x7(STEM_FEATURES, mode=mode).to(dev)
            with torch.no_grad():
                stem.weight.copy_(weight)
            stem = stem.to(memory_format=torch.channels_last)

            def fwd(stem=stem, xin=x):  # autocast's cast cache off: a graph holds the backward
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp,
                                    cache_enabled=False):
                    return stem(xin)

            def fwd_bwd(stem=stem, fwd=fwd):
                return torch.autograd.grad(fwd(), stem.weight, gy.to(dtype))[0]

            with torch.no_grad():
                y = fwd().float()
            dw = fwd_bwd().float()
            row = {"forward_backward": _ms_pair(fwd_bwd)}
            if mode == "direct":
                ref = (y, dw)
                # dW's floor: the direct conv's with its input moved one ulp of its dtype
                ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
                moved = functools.partial(fwd, xin=x * (1 + ulp))
                row["dw_floor"] = _rel(fwd_bwd(fwd=moved).float(), dw)
                row["dw_tol"] = (TOL_TRAIN_NOISE_FACTOR * row["dw_floor"] + TOL_F32_GRAD
                                 if dtype == torch.float32
                                 else max(TOL_FUNCTION, TOL_TRAIN_NOISE_FACTOR * row["dw_floor"]))
            else:
                row["max_rel_diff"] = _rel(y, ref[0])
                row["dw_max_rel_diff"] = _rel(dw, ref[1])
            out[f"{key}_{mode}"] = row
            del stem
    out["tol"] = {"f32": TOL_F32["conv3x3_same"], "bf16": TOL_BF16}
    print("alternates_stem " + json.dumps(out), flush=True)
    ok = all(out[f"{k}_{m}"]["max_rel_diff"] <= out["tol"][k]
             and out[f"{k}_{m}"]["dw_max_rel_diff"] <= out[f"{k}_direct"]["dw_tol"]
             for k in ("f32", "bf16") for m in alt.STEM_MODES if m != "direct")
    if not ok:
        raise AssertionError(f"stem modes against direct: {out}")
    return out


def _ulps_apart(a: dict, b: dict, init: dict) -> tuple[float, dict]:
    """The largest difference of two state dicts' float tensors after a step from ``init``, in
    f32 ulps of the largest of the value before, the values after and the update there (the
    update carries its ops' roundings, whatever the result); where (key, flat index, the
    values) and how many elements are more than one ulp apart."""
    worst, where, over = 0.0, {}, 0
    for k, v in b.items():
        if not torch.is_floating_point(v):
            continue
        top = torch.stack([a[k].abs(), v.abs(), init[k].abs(), (v - init[k]).abs()]).amax(0)
        top = top.float()
        ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
        d = ((a[k].double() - v.double()).abs() / ulp.double()).flatten()
        over += int((d > 1).sum())
        i = int(d.argmax())
        if d[i].item() > worst:
            worst = d[i].item()
            where = {"key": k, "index": i, "values": [a[k].flatten()[i].item(),
                                                      v.flatten()[i].item(),
                                                      init[k].flatten()[i].item()]}
    return worst, {**where, "elements_over_one_ulp": over}


def _optimizer_ms(opt) -> dict:
    """The optimizer's own step, its gradients as the last backward left them, per call:
    ``busy_ms``, the card's kernel time in a profiler window over ``OPT_TIMED_CALLS`` calls
    (``utils/timing.device_ms_by_group``, as the profile scripts read a step); ``stream_ms``,
    CUDA events around the same calls back to back, launch gaps included (the foreach
    update's ~10 launches a tensor group keep the card waiting on the host); ``host_ms``, the
    host's time to issue one call, the card idle before it."""
    from unet_embroidery_seg_torch.utils.timing import device_ms_by_group

    host = []
    for _ in range(OPT_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(OPT_TIMED_CALLS):
        opt.step()
    end.record()
    end.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(OPT_TIMED_CALLS):
            opt.step()
        torch.cuda.synchronize()
    by_group, top = device_ms_by_group(prof, OPT_TIMED_CALLS)
    if not by_group:
        raise AssertionError("the optimizer's profiler window holds no card time")
    return {"busy_ms": sum(by_group.values()), "busy_ms_by_group": by_group,
            "kernels_per_call": sum(e.count for e in prof.key_averages()
                                    if e.device_type == torch.autograd.DeviceType.CUDA
                                    and not e.key.startswith("Optimizer."))
            / OPT_TIMED_CALLS,
            "stream_ms": start.elapsed_time(end) / OPT_TIMED_CALLS,
            "host_ms": statistics.median(host)}


def flat_adam_check(counters) -> dict:
    """18c: FlatAdam against the foreach Adam on unet_resnet50's resident bf16 steps."""
    from unet_embroidery_seg_torch.engine import resident

    cache, data = resident_split()
    del cache
    out = {"model": "unet_resnet50", "task": "binary", "loss": "lovasz_hinge", "amp": True,
           "size": TRAIN_SIZE, "batch": BATCH, "chunk": RESIDENT_CHUNK,
           "timed_order": ["tree", "flat", "flat", "tree"]}
    x = torch.rand(BATCH, 3, TRAIN_SIZE, TRAIN_SIZE,
                   generator=torch.Generator().manual_seed(18)).to("cuda")
    x = x.contiguous(memory_format=torch.channels_last)

    def forward(m):  # an eval forward, grad off: packed weights from the cache
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return m.eval()(x).float()

    runs, models, starts = {}, {}, []
    deterministic = torch.backends.cudnn.deterministic
    for variant in ("tree", "flat"):
        model, step, opt = _resident_binary_model(variant=variant)
        before = forward(model) if variant == "flat" else None  # fills the packing cache
        chunk = resident.make_train_chunk_fn(step, (TRAIN_SIZE, TRAIN_SIZE), True, 2, seed=11)
        _, (idx, mask) = _plan(data, 0, 1)
        torch.backends.cudnn.deterministic = True
        try:
            first = chunk(data, idx, mask, 0, range(1)).cpu().tolist()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        runs[variant] = {"first_loss": first[0],
                         "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
        if variant == "tree":  # the first step's gradients, for the same-gradient check
            tree_grads = [p.grad.detach().clone() for p in model.parameters()]
        else:  # phase 5's rule: the step seen, as a fresh model sees it
            after = forward(model)
            fresh, _ = _resident_binary_model()
            fresh.load_state_dict(runs[variant]["state"])
            runs[variant]["eval_after_step"] = {
                "changed": (after - before).abs().max().item(),
                "off_fresh": (after - forward(fresh)).abs().max().item()}
            del fresh

        def marked(*args, step=step):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            return step(*args)

        timed = resident.make_train_chunk_fn(marked, (TRAIN_SIZE, TRAIN_SIZE), True, 2, seed=11)
        _, plan = _plan(data, 1, RESIDENT_CHUNK)
        timed(data, *plan, 1, range(RESIDENT_CHUNK)).cpu()  # warm-up
        models[variant] = (model, opt, timed)
        runs[variant].update(step_ms=[], losses=[])
    # Timed chunks, the variants alternating (tree, flat, flat, tree), with the
    # launch counters zeroed just before and read just after.
    for c in counters:
        c.launches = 0
    for k, variant in enumerate(out["timed_order"]):
        starts.clear()
        _, plan = _plan(data, 2 + k, RESIDENT_CHUNK)
        values = models[variant][2](data, *plan, 2 + k, range(RESIDENT_CHUNK))
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        runs[variant]["losses"] += values.cpu().tolist()
        marks = starts + [end]
        runs[variant]["step_ms"] += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    out["launches"] = {c.__name__: c.launches for c in counters}
    for variant, (model, opt, _) in models.items():
        runs[variant]["step_ms_median"] = statistics.median(runs[variant]["step_ms"])
        runs[variant]["optimizer"] = _optimizer_ms(opt)
    del models, model, opt
    torch.cuda.empty_cache()
    # The two runs' own first steps (their gradients may differ: a backward op
    # that is not deterministic), then the optimizers on the same gradients:
    # FlatAdam from the initial state with the tree run's first gradients.
    model, _, opt = _resident_binary_model(variant="flat")
    names = [n for n, _ in model.named_parameters()]  # the parameters, not BN's statistics
    tree_params = {n: runs["tree"]["state"][n] for n in names}
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    own, own_at = _ulps_apart({n: runs["flat"]["state"][n] for n in names}, tree_params, init)
    del runs["tree"]["state"], runs["flat"]["state"]
    opt.zero_grad()
    for p, g in zip(model.parameters(), tree_grads):
        p.grad.copy_(g)
    opt.step()
    ulps, where = _ulps_apart({n: p.detach() for n, p in model.named_parameters()}, tree_params,
                              init)
    if where.get("key"):
        g = tree_grads[names.index(where["key"])].flatten()[where["index"]].item()
        where["gradient"] = g
    del model, opt, tree_grads, tree_params, init
    out.update(runs, first_loss_equal=runs["flat"]["first_loss"] == runs["tree"]["first_loss"],
               own_steps_ulps_apart=own, own_steps_ulps_apart_at=own_at,
               same_gradients_ulps_apart=ulps, same_gradients_ulps_apart_at=where,
               flat_over_tree_step_ms=runs["flat"]["step_ms_median"]
               / runs["tree"]["step_ms_median"])
    want = {k: v * 4 * RESIDENT_CHUNK for k, v in RESNET_PER_STEP.items()
            if k in out["launches"]}
    print("alternates_flat_adam " + json.dumps(out), flush=True)
    seen = runs["flat"]["eval_after_step"]
    ok = (out["first_loss_equal"] and ulps <= FLAT_STEP_ULPS
          and seen["changed"] > 0 and seen["off_fresh"] <= 0.1 * seen["changed"]
          and out["launches"] == want
          and all(np.isfinite(runs[v]["losses"]).all() for v in runs))
    if not ok:
        raise AssertionError(f"FlatAdam against the foreach Adam: {out}")
    del data
    torch.cuda.empty_cache()
    return out


def _flat_step(model, batch, group=None, space=None) -> float:
    """One f32 Lovasz step of ``model`` with FlatAdam at the CLI's learning rate."""
    from unet_embroidery_seg_torch.engine.steps import make_binary_train_step

    opt = _alternates().make_optimizer("flat", model.parameters(), TRAIN_LR)
    step = make_binary_train_step(model, opt, "lovasz_hinge", None, amp=False, group=group,
                                  space=space)
    return float(step(*batch))


def _flat_space_rank(rank: int, devices: list, out_dir: str) -> None:
    """One rank of 18c's 1x2 mesh (gloo, two ranks on one card): one f32 FlatAdam step."""
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_dgrad
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward
    from unet_embroidery_seg_torch.parallel import halo
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(1, SPACE_SPLIT, devices)
    counters = [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad]
    model, batch = _sgd_model_and_batch(mesh.device)
    for c in counters:
        c.halo_launches = 0
    loss = _flat_step(model, mesh_lib.shard_batch_arrays(mesh, *batch), mesh.group,
                      halo.space_axis(mesh))
    torch.save({"loss": loss, "halo_launches": {c.__name__: c.halo_launches for c in counters},
                "state": {k: v.cpu() for k, v in model.state_dict().items()}},
               os.path.join(out_dir, f"flat_rank{rank}.pt"))


def flat_space_one_card() -> dict:
    """18c: a 1x2 mesh's FlatAdam step on two gloo ranks of the one card against one process."""
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    init, batch = _sgd_model_and_batch("cpu")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    one = {}
    for run, scale in (("one", 1.0), ("one_up", 1 + 2.0 ** -23), ("one_down", 1 - 2.0 ** -23)):
        model, _ = _sgd_model_and_batch("cuda")
        images, pngs, sm = batch
        one[run] = (_flat_step(model, (images * np.float32(scale), pngs, sm)),
                    {k: v.cpu() for k, v in model.state_dict().items()})
        del model
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="flat-ranks-")
    t0 = time.perf_counter()
    try:
        mesh_lib.launch_local(_flat_space_rank, SPACE_SPLIT,
                              ([torch.device("cuda", 0)] * SPACE_SPLIT, out_dir),
                              backend="gloo", timeout_s=600)
        ranks = [torch.load(os.path.join(out_dir, f"flat_rank{r}.pt"), weights_only=True)
                 for r in range(SPACE_SPLIT)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    states = [r.pop("state") for r in ranks]
    result = {"mesh": "1x2", "backend": "gloo", "devices": "cuda:0 x2", "optimizer": "flat",
              "lr": TRAIN_LR, "seconds": time.perf_counter() - t0,
              "loss_space": ranks[0]["loss"], "loss_one_process": one["one"][0],
              "loss_rel_diff": abs(ranks[0]["loss"] - one["one"][0]) / abs(one["one"][0]),
              "ranks_bit_equal": all(torch.equal(states[0][k], states[1][k]) for k in states[0]),
              "halo_launches_per_rank": [r["halo_launches"] for r in ranks]}
    entries, ok = _update_rule(states[0], one["one"][1], one["one_up"][1], one["one_down"][1],
                               init)
    result.update(entries)
    print("alternates_flat_space " + json.dumps(result), flush=True)
    want = {"upsample2x": 5, "upsample2x_backward": 5, "conv3x3_bias_relu": 6,
            "conv3x3_dgrad": 6}
    if not (ok and result["ranks_bit_equal"] and result["loss_rel_diff"] <= TOL_DDP_LOSS_F32
            and all(r["halo_launches"] == want for r in ranks)):
        raise AssertionError(f"FlatAdam over the space axis: {result}")
    return result


def alternates_phase(counters) -> dict:
    """Phase 18: the packed tail, the stem modes and FlatAdam, each against its default."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"packed_tail": packed_tail_check(torch.Generator().manual_seed(181)),
           "stem": stem_modes_check(torch.Generator().manual_seed(182))}
    torch.cuda.empty_cache()
    out["flat_adam"] = flat_adam_check(counters)
    out["flat_space"] = flat_space_one_card()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {out['seconds']:.1f} s", flush=True)
    return out


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
# The tf32x3 path's grad-mode weight pack (forward and dgrad planes in one
# launch), part of the conv's port: f32 entries only.
PACK_META = {"conv3x3_pack_tf32x3": ("unet_embroidery_seg_torch/csrc/conv3x3_same.cu",
                                     "docs/negative-results/pallas_conv.py:61",
                                     "pack_conv3x3_grad")}
# The families' entries: the same kernels at their new sites, under names of
# their own: (kernel, launch counter, dtype of the sites summed).
FAMILY_KERNELS = {
    "upsample2x[align_corners=False]": ("upsample2x", "upsample2x", "torch.bfloat16"),
    "upsample2x_backward[align_corners=False]": ("upsample2x_backward", "upsample2x_backward",
                                                 "torch.bfloat16"),
    "conv3x3_same[no epilogue]": ("conv3x3_same", "conv3x3_same", "torch.bfloat16"),
    "conv3x3_dgrad[DoubleConv]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.bfloat16"),
}
# The f32 (``--no-amp``) entries: the conv on ``tf32x3`` at the DoubleConv
# sites, launches from phase 9's f32 steps of unet_plain.
F32_KERNELS = {
    "conv3x3_same[f32]": ("conv3x3_same", "conv3x3_same", "torch.float32"),
    "conv3x3_dgrad[f32]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.float32"),
    "conv3x3_pack_tf32x3[f32]": ("conv3x3_pack_tf32x3", "pack_conv3x3_grad", "torch.float32"),
}
# The f32 entries at unet_resnet50's (and multitask_unet's) sites, phase 10's
# rows, launches from phase 10b's f32 steps of multitask_unet.
F32_RESNET_KERNELS = {
    "upsample2x[align_corners=True,f32]": ("upsample2x", "upsample2x", "torch.float32"),
    "upsample2x_backward[align_corners=True,f32]": ("upsample2x_backward", "upsample2x_backward",
                                                    "torch.float32"),
    "conv3x3_same[fused,f32]": ("conv3x3_same", "conv3x3_bias_relu", "torch.float32"),
    "conv3x3_dgrad[fused,f32]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.float32"),
    "conv3x3_pack_tf32x3[fused,f32]": ("conv3x3_pack_tf32x3", "pack_conv3x3_grad",
                                       "torch.float32"),
}


def _summary_entry(name: str, kernel: str, rows: list[dict], launches: int, sites: str,
                   dtype: str = "torch.bfloat16") -> dict:
    """One ``kernels`` entry: a pass over the ``dtype`` model sites of ``kernel`` in ``rows``.

    A pass runs its sites one after another, each ``count`` times, so its
    times and its bound are the counted sums of theirs; bound_by names the
    limit behind most of that bound. Rows of no model site (``count`` 0)
    are held but not summed.
    """
    source, replaces, _ = {**KERNEL_META, **PACK_META}[kernel]
    mine = [r for r in rows if r["kernel"] == kernel and r["dtype"] == dtype and r["count"] > 0]

    def total(key):  # None where a row has none (no library call computes the pack)
        vals = [r[key] for r in mine]
        return None if None in vals else sum(v * r["count"] for v, r in zip(vals, mine))

    share: dict[str, float] = {}
    for r in mine:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["bound_ms"] * r["count"]
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms_method": MS_METHOD, "ms": total("ms"), "eager_ms": total("eager_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": sum(share.values()),
        "bound_by": max(share, key=share.get), "library_ms": total("library_ms"),
        "library_eager_ms": total("library_eager_ms"), "sites": sites,
        "paths": sorted({r["path"] for r in mine}),
    }
    if all("fma_ms" in r for r in mine):
        entry.update({"fma_ms": total("fma_ms"), "cuda_core_bound_ms": total("cuda_core_bound_ms")})
    if all("flipped_ms" in r for r in mine):  # dgrad: the flipped-packing composition beside it
        entry.update({k: total(k) for k in ("flipped_ms", "flipped_pack_ms", "grad_pack_ms")})
    return entry


# Phase 16's entries: the halo-padded conv and the band upsample over a 1x2
# mesh, one rank's pass (shard 0's rows); launches: rank 0's halo launches
# in 16b's bf16 steps, and in its f32 SGD step for the f32 entries.
SPACE_KERNELS = {
    "upsample2x[band]": ("upsample2x", "upsample2x", "torch.bfloat16"),
    "upsample2x_backward[band]": ("upsample2x_backward", "upsample2x_backward",
                                  "torch.bfloat16"),
    "conv3x3_same[fused,halo]": ("conv3x3_same", "conv3x3_bias_relu", "torch.bfloat16"),
    "conv3x3_dgrad[fused,halo]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.bfloat16"),
    "upsample2x[band,f32]": ("upsample2x", "upsample2x", "torch.float32"),
    "upsample2x_backward[band,f32]": ("upsample2x_backward", "upsample2x_backward",
                                      "torch.float32"),
    "conv3x3_same[fused,halo,f32]": ("conv3x3_same", "conv3x3_bias_relu", "torch.float32"),
    "conv3x3_dgrad[fused,halo,f32]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.float32"),
}


# Phase 17's entries: the bias-free conv's halo mode and the align_corners=False
# band upsample at the families' sites over a 1x2 mesh, one rank's pass;
# launches: rank 0's halo launches summed over 17b's runs of the three
# families (bf16 steps; the f32 SGD step for the f32 entries).
FAMILY_SPACE_KERNELS = {
    "upsample2x[align_corners=False,band]": ("upsample2x", "upsample2x", "torch.bfloat16"),
    "upsample2x_backward[align_corners=False,band]": ("upsample2x_backward",
                                                      "upsample2x_backward", "torch.bfloat16"),
    "conv3x3_same[no epilogue,halo]": ("conv3x3_same", "conv3x3_same", "torch.bfloat16"),
    "conv3x3_dgrad[DoubleConv,halo]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.bfloat16"),
    "upsample2x[align_corners=False,band,f32]": ("upsample2x", "upsample2x", "torch.float32"),
    "upsample2x_backward[align_corners=False,band,f32]": ("upsample2x_backward",
                                                          "upsample2x_backward", "torch.float32"),
    "conv3x3_same[no epilogue,halo,f32]": ("conv3x3_same", "conv3x3_same", "torch.float32"),
    "conv3x3_dgrad[DoubleConv,halo,f32]": ("conv3x3_dgrad", "conv3x3_dgrad", "torch.float32"),
}


def kernel_summary(rows: list[dict], launches: dict, family_rows: list[dict],
                   family_launches: dict, f32_launches: dict, f32_resnet_rows: list[dict],
                   f32_resnet_launches: dict, space: dict, family_space: dict) -> list[dict]:
    """Every kernel entry: unet_resnet50's sites, the families' sites, the f32 ones, the halo ones.

    ``launches`` are unet_resnet50's train path's counts; ``family_launches``
    the three families' train paths' counts summed; ``f32_launches`` phase
    9's f32 train path's counts; ``f32_resnet_launches`` phase 10b's f32
    steps of multitask_unet; ``space`` phase 16's result, ``family_space``
    phase 17's.
    """
    out = []
    for kernel, (_, _, counter) in KERNEL_META.items():
        where = "480^2 forward" if kernel in ("upsample2x", "conv3x3_same") else "512^2 backward"
        out.append(_summary_entry(kernel, kernel, rows, launches[counter],
                                  f"unet_resnet50, {where}"))
    for name, (kernel, counter, dtype) in FAMILY_KERNELS.items():
        where = "480^2 forward" if kernel in ("upsample2x", "conv3x3_same") else "512^2 backward"
        out.append(_summary_entry(name, kernel, family_rows, family_launches[counter],
                                  f"unet_plain, attention_unet, dualdense_unet, {where}", dtype))
    for name, (kernel, counter, dtype) in F32_KERNELS.items():
        where = "480^2 forward" if kernel == "conv3x3_same" else "512^2 backward"
        out.append(_summary_entry(name, kernel, family_rows, f32_launches[counter],
                                  f"unet_plain, attention_unet in f32 (--no-amp), {where}", dtype))
    for name, (kernel, counter, dtype) in F32_RESNET_KERNELS.items():
        where = "forward" if kernel in ("upsample2x", "conv3x3_same") else "backward"
        out.append(_summary_entry(name, kernel, f32_resnet_rows, f32_resnet_launches[counter],
                                  "unet_resnet50, multitask_unet in f32 (--no-amp), "
                                  f"512^2 {where}", dtype))
    one_card = space["one_card"]
    for name, (kernel, counter, dtype) in SPACE_KERNELS.items():
        where = "forward" if kernel in ("upsample2x", "conv3x3_same") else "backward"
        launches = (one_card["bf16"]["halo_launches_per_rank"][0][counter]
                    if dtype == "torch.bfloat16"
                    else one_card["sgd"]["halo_launches_per_rank"][0][counter])
        out.append(_summary_entry(name, kernel, space["sites"], launches,
                                  f"unet_resnet50 on a 1x2 mesh, one rank's band of 512^2, "
                                  f"{where}", dtype))
    runs = family_space["one_card"]["runs"]
    for name, (kernel, counter, dtype) in FAMILY_SPACE_KERNELS.items():
        where = "forward" if kernel in ("upsample2x", "conv3x3_same") else "backward"
        if dtype == "torch.bfloat16":
            launches = sum(r["bf16"]["halo_launches_per_rank"][0][counter]
                           for key, r in runs.items() if not key.startswith("multitask"))
        else:
            launches = sum(r["sgd"]["halo_launches_per_rank"][0][counter]
                           for key, r in runs.items() if not key.startswith("multitask"))
        out.append(_summary_entry(name, kernel, family_space["sites"], launches,
                                  "unet_plain, attention_unet, dualdense_unet on a 1x2 mesh, "
                                  f"one rank's band of 512^2, {where}", dtype))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the full report as JSON here")
    parser.add_argument("--multi-card-only", action="store_true",
                        help="build the kernels and run phases 12d (two cards), 16c and 17c "
                             "(four cards) alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from unet_embroidery_seg_torch.ops import _build
    from unet_embroidery_seg_torch.ops.conv3x3 import (
        conv3x3_bias_relu,
        conv3x3_dgrad,
        conv3x3_same,
        pack_conv3x3_grad,
    )
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward
    from unet_embroidery_seg_torch.utils.device import card_line, set_float32_precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build(["upsample2x", "upsample2x_bwd", "conv3x3_same"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    if args.multi_card_only:
        _, data = resident_split()
        counters = [upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad]
        result = two_cards(_resident_chunks(None, counters, data))
        del data
        torch.cuda.empty_cache()
        space = space_four_cards()
        family_space = family_space_four_cards()
        print(json.dumps({"two_cards": result, "space_four_cards": space,
                          "family_space_four_cards": family_space,
                          "seconds": time.perf_counter() - t_start}))
        print(card)
        return 0 if result["ran"] and space["ran"] and family_space["ran"] else 1

    rows = check_sites(torch.Generator().manual_seed(0))
    update = weight_update_check(torch.Generator().manual_seed(2))
    bwd_rows = check_backward_sites(torch.Generator().manual_seed(4))
    functions = function_check(torch.Generator().manual_seed(5))
    graph_check = dgrad_graph_check(torch.Generator().manual_seed(3))
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
        families[name] = {
            "predict": main_path(forward_counters, name, FAMILY_FORWARD_LAUNCHES[name]),
            "train": train_path(train_counters, name, "bce", FAMILY_TRAIN_STEPS,
                                family_per_step(name)),
        }
        torch.cuda.empty_cache()
    for name in ("unet_plain", "attention_unet"):
        families[name]["f32_train_card_vs_cpu"] = f32_train_card_vs_cpu(name)
    # The paper pipeline's --no-amp run: f32 convs, cuDNN's with TF32 as
    # PyTorch has it by default (the train CLI sets it so).
    set_float32_precision()
    f32_full = train_path(train_counters + [pack_conv3x3_grad], "unet_plain", "bce",
                          FAMILY_F32_STEPS,
                          {**FAMILY_FORWARD_LAUNCHES["unet_plain"], "upsample2x_backward": 4,
                           "conv3x3_dgrad": 9, "pack_conv3x3_grad": 9}, amp=False, checks=False)
    torch.backends.cudnn.allow_tf32 = False

    # Phase 10: multitask_unet and the multiclass task.
    f32_resnet_rows = check_f32_resnet_sites(torch.Generator().manual_seed(10))
    tasks = {"multitask_bf16": task_train_path(train_counters, "multitask", "multitask_unet",
                                               "bce", TASK_TRAIN_STEPS, RESNET_PER_STEP)}
    torch.cuda.empty_cache()
    set_float32_precision()  # 10b: --no-amp, cuDNN with PyTorch's default TF32
    for key, task, name, loss in (("multitask_f32", "multitask", "multitask_unet", "bce"),
                                  ("multiclass_f32_ce", "multiclass", "unet_resnet50", "ce"),
                                  ("multiclass_f32_focal", "multiclass", "unet_resnet50", "focal")):
        tasks[key] = task_train_path(train_counters + [pack_conv3x3_grad], task, name, loss,
                                     TASK_F32_STEPS, {**RESNET_PER_STEP, "pack_conv3x3_grad": 6},
                                     amp=False, checks=False)
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    tasks["multiclass_bf16"] = task_train_path(
        train_counters, "multiclass", "unet_plain", "ce", TASK_TRAIN_STEPS,
        {**FAMILY_FORWARD_LAUNCHES["unet_plain"], "upsample2x_backward": 4, "conv3x3_dgrad": 9})
    torch.cuda.empty_cache()
    tasks["f32_multitask_card_vs_cpu"] = f32_multitask_card_vs_cpu()
    torch.cuda.empty_cache()

    # Phase 11: the device-resident input path.
    t11 = time.perf_counter()
    cache, data = resident_split()
    res = {"augment": resident_augment_check(cache, data)}
    res["train"], model = resident_train_path(train_counters, cache, data)
    res["eval"] = resident_eval_check(model, cache, data)
    del model
    torch.cuda.empty_cache()
    res["multitask"] = resident_multitask_path(train_counters, data)
    res["seconds"] = time.perf_counter() - t11

    # Phase 12: data parallelism.
    ddp = data_parallel_phase([upsample2x, upsample2x_backward, conv3x3_bias_relu,
                               conv3x3_dgrad], data)

    # Phase 13: the tooling.
    tooling = tooling_phase(train_counters, data, res["train"]["step_ms_median"])
    del cache, data
    torch.cuda.empty_cache()

    # Phase 14: the paper pipeline; phase 15: a short leg of the accuracy study.
    paper = {"pipeline": pipeline_phase(train_counters), "study": study_phase(train_counters)}
    torch.backends.cudnn.allow_tf32 = False

    # Phase 16: the mesh's space axis; phase 17: for the other families and tasks.
    space = space_phase([upsample2x, upsample2x_backward, conv3x3_bias_relu, conv3x3_dgrad])
    family_space = family_space_phase()

    # Phase 18: the JAX package's alternates against their defaults.
    alternates = alternates_phase([upsample2x, upsample2x_backward, conv3x3_bias_relu,
                                   conv3x3_dgrad])

    family_launches = {c.__name__: sum(f["train"]["launches"][c.__name__]
                                       for f in families.values())
                       for c in train_counters}
    kernels = kernel_summary(rows + bwd_rows, train["launches"], family_rows, family_launches,
                             f32_full["launches"], f32_resnet_rows,
                             tasks["multitask_f32"]["launches"], space, family_space)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "dgrad_graph": graph_check, "sites": rows,
                       "weight_update": update, "backward_sites": bwd_rows,
                       "function_check": functions, "main_path": path, "train_path": train,
                       "f32_card_vs_cpu": f32, "f32_train_card_vs_cpu": f32_train,
                       "family_sites": family_rows, "family_function_check": family_functions,
                       "packing_cost": packing, "families": families,
                       "f32_full_width_train": f32_full, "f32_resnet_sites": f32_resnet_rows,
                       "tasks": tasks, "resident": res, "data_parallel": ddp,
                       "tooling": tooling, "paper": paper, "space": space,
                       "family_space": family_space, "alternates": alternates,
                       "kernels": kernels,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
