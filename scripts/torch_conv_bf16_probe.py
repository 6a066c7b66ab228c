#!/usr/bin/env python3
"""conv3x3's bf16 kernels (``wgmma``, C > 64; ``c64_persistent``, C <= 64): what holds them back,
and a checkout against this one.

    python scripts/torch_conv_bf16_probe.py split [--root DIR]   # timing-only variants of a kernel
    python scripts/torch_conv_bf16_probe.py split --layout resident|c64 [--root DIR]   # C <= 64
    python scripts/torch_conv_bf16_probe.py shift                # the C <= 64 kernel's shifted B
    python scripts/torch_conv_bf16_probe.py root --root DIR [--layout resident]   # DIR's against this

``split``: the bf16 streamed instance of ``csrc/conv3x3_same.cu`` at
``--root`` (default: this checkout), ``conv3x3_wgmma_kernel<bf16, 128,
STREAMED, ...>``, at the shapes of ``SHAPES`` (the families' bias-free
forward at 480^2, unet_resnet50's fused 128@120, the families' dgrad
128@256 and the band dgrads of a 1x2 mesh), batch 8, as built and with one
cause of lost time taken away at a time. The variants exist for timing;
most compute wrong values:

- ``resident_w``: each weight stage loaded for a CTA's first pass of the
  ring only, then re-read as it stands (no L2 weight reloads);
- ``no_store``: the epilogue's TMA stores skipped (staging and barriers kept);
- ``no_epilogue``: the whole bf16 epilogue skipped, the accumulators kept
  live (ptxas drops a wgmma whose result is unused);
- ``no_drain``: no ``wgmma_wait<0>`` at each chunk's end: tap 8 takes a third
  A buffer, so the next chunk's ldmatrix never writes registers a wgmma in
  flight reads, and its weight stage is released at the next chunk's first
  wait (or the item's end).

On the clustered kernel, also:

- ``release_cluster``: a stage's remote release at cluster scope
  (``mbarrier.arrive.release.cluster``);
- ``no_multicast``: still clusters, but each CTA loads its whole weight
  stage itself;
- ``store_wait``: each storing thread waits for its store's read right
  after it, not at the buffer's next use;
- ``lag4``: the second consumer warpgroup starts 4 taps after the first;
- ``ring_6_3``: the single-CTA kernel's rings (6 weight stages, 3 halo).

``no_drain`` and the clustered kernel's variants change no value and are
held bit for bit against the kernel as built.

``split --layout resident``: the same for the C <= 64 instance as it stood
before its redesign (``conv3x3_wgmma_kernel<bf16, 64, RESIDENT, ...>``: a
128-pixel tile per consumer warpgroup as two m64 slabs, A by ``ldmatrix``
from the halo stage, the 9 taps' weights resident), at ``RES_SHAPES`` (the
fused 64@480^2 and 64@240^2, the bias-free 64@480^2, dgrad 64@512^2 and
64@256^2, a band's forward at pads (1, 0) and its dgrad at (1, 2)), with
``RES_VARIANTS``:

- ``no_ldsm``: A's ``ldmatrix`` at the first two taps only (one per
  register buffer), then reused;
- ``one_slab``: the second slab's ``wgmma`` skipped (B read once per k
  step), its accumulators kept live (stored as zeros);
- ``no_store``, ``no_epilogue``: as above;
- ``store_defer``: the storing thread waits for its store's read at the
  next item's epilogue, not right after the store, and only then releases
  the halo stage the output was staged in;
- ``ring2``: a 2-stage halo ring per group (3 as built).

``store_defer`` and ``ring2`` change no value and are held bit for bit.

``split --layout c64``: the redesigned kernel (``conv3x3_c64_kernel``) at
the same shapes, with ``C64_VARIANTS``: ``no_mma`` (one wgmma an item: the
loads, barriers and epilogue alone), ``no_epilogue``, ``no_store`` (its
global stores), ``no_load`` (halos loaded for the ring's first pass only),
``aligned_b`` (B's start row rounded down to a multiple of 8), and three
that change no value, held bit for bit: ``lag1`` (the second warpgroup
starts one item late), ``tile_30`` (every call on the 30 x 8 tile),
``scale0`` (the first wgmma of an item overwrites the accumulators instead
of their being zeroed). ``--variants a,b`` times a subset; a variant whose
first call faults is named by the last ``split_ran`` line.

``shift``: one warpgroup's ``wgmma.m64n256k16`` with both operands read
from shared memory through descriptors, A the weights (K-major, or MN-major
read transposed as dgrad does) and B a 128-byte-swizzled halo stage at a
row offset of one pixel or more, the redesigned C <= 64 kernel's operand
form, against the same product in f32 on the card (the values are small
integers, exact in bf16 and in the sum). Each row offset is tried with the
descriptor's start address moved alone (``plain``) and with its base-offset
field set as well (``base_offset``). A variant whose kernel text is not in the source is skipped (``skipped``).
Each source is built into ``build/conv_bf16_probe/`` with ``nvcc -Xptxas -v``
(all at once) and timed by graph replay in turns: as built, every variant,
every variant again in reverse, as built. Also printed: ptxas's registers,
spills and warnings for the bf16 instances at 128 output channels.

``root``: ``--root``'s ``conv3x3_same.cu`` (an older checkout, unpacked with
``git archive``) against this checkout's, both through this checkout's
wrappers (the C interface and the weight packing are the same); with
``--layout resident`` (or ``c64``) at the C <= 64 cases of
``RES_ROOT_CASES`` (the probe's shapes timed, then C = 16-64 at every pad,
ragged widths, batch 1), each also held to ``TOL_BF16`` of the plain
version, else at every streamed case of ``ROOT_CASES``: the fused forward, the bias-free forward
and dgrad at SAME and halo pads ((1, 0), (0, 1); dgrad (1, 2), (2, 1)),
C = 80 and 128-1024, ragged widths, batch 1 and 8. The two outputs are
compared bit for bit on the same seeded inputs; the ``timed`` cases are
timed in turns (root, this, this, root) beside one PyTorch call of the same
function (``F.conv2d``; dgrad ``conv2d_input``). ``same_code`` lists the
kernels the two sources compile to the same SASS (``cuobjdump``) and those
that differ or exist in one only; ``other_kernels_identical`` says whether
every kernel outside the compared path is unchanged.

The build, timing, SASS and comparison helpers are
``scripts/torch_conv_f32_probe.py``'s. Prints one JSON line per result.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_conv_f32_probe as f32probe  # noqa: E402

ROOT = f32probe.ROOT
OUT = ROOT / "build" / "conv_bf16_probe"
BATCH = 8
# The bf16 instances at 128 output channels (mangled): STREAMED is layout 0.
BF16_128 = "I13__nv_bfloat16Li128"
PEAK_BF16, HBM = 989e12, 3.35e12  # H100 SXM data sheet: dense bf16 FLOP/s, bytes/s

# (label, mode, C, N, input rows, width, pad): the shapes where the streamed
# instance trails cuDNN or reads under half of its bound (PERF.md, PR 16).
# dgrad's ``pad`` is the forward's: its g has out_rows(h, pad) rows and it
# runs at dgrad_pad(pad), as a band's backward does.
SHAPES = [
    ("128@240", "same", 128, BATCH, 240, 240, (1, 1)),
    ("256@120", "same", 256, BATCH, 120, 120, (1, 1)),
    ("512@60", "same", 512, BATCH, 60, 60, (1, 1)),
    ("1024@30", "same", 1024, BATCH, 30, 30, (1, 1)),
    ("128@120.fused", "fused", 128, BATCH, 120, 120, (1, 1)),
    ("128@256.dgrad", "dgrad", 128, BATCH, 256, 256, (1, 1)),
    ("512@17x32.dgrad", "dgrad", 512, BATCH, 17, 32, (1, 0)),
    ("1024@17x32.dgrad", "dgrad", 1024, BATCH, 17, 32, (1, 0)),
]

W_LOAD = "              mbar_expect_tx(wfull + 8 * ws, C::W_TILE);"
STORE = "          if (co_t * BN + half * 64 < p.c)"
EPILOGUE = "\n      named_bar_sync(1 + g, 128 * C::WGS);  // the previous store has read the buffer"
DRAIN = ("        wgmma_wait<0>();\n"
         "        if (!RESIDENT_W) mbar_arrive(wempty + 8 * prev_ws);\n")
ITEM_END = "#pragma unroll\n      for (int s = 0; s < SLABS; ++s) fence_operands(acc[s]);"
# The clustered kernel's epilogue: each warpgroup stores its own half of the tile.
STORE_WG = "tma_store_4d(&ymap, stage_wg + half"
EPILOGUE_WG = "        const int half_px = p.th / 2 * p.tw;\n"
SKIP_EPILOGUE = ("        {\n"
                 "          float sum = 0.0f;\n"
                 "          for (int i = 0; i < BN / 2; ++i) sum += acc[0][i];\n"
                 "          if (sum == 1234.5f) __trap();\n"
                 "          continue;\n"
                 "        }\n")

# name -> alternatives, each a list of (text, replacement); the first
# alternative whose texts all occur once in the kernel is taken.
VARIANTS = {
    "resident_w": [[(W_LOAD, "              if (wi >= C::W_STAGES) { mbar_arrive(wfull + 8 * ws); "
                             "continue; }\n" + W_LOAD)]],
    "no_store": [[(STORE_WG, "if (p.c < 0) " + STORE_WG)],
                 [(STORE, "          if (co_t * BN + half * 64 < 0)")]],
    "no_epilogue": [[(EPILOGUE_WG, SKIP_EPILOGUE + EPILOGUE_WG)],
                    [(EPILOGUE, "\n      {\n"
                                "        float sum = 0.0f;\n"
                                "        for (int s = 0; s < SLABS; ++s)\n"
                                "          for (int i = 0; i < BN / 2; ++i) sum += acc[s][i];\n"
                                "        if (sum == 1234.5f) __trap();\n"
                                "        if (C::STAGE_IN_HALO) mbar_arrive(hempty + 8 * last_hs);\n"
                                "        continue;\n"
                                "      }" + EPILOGUE)]],
    "no_drain": [[
        ("        uint32_t a[2][SLABS][KS][4];", "        uint32_t a[3][SLABS][KS][4];"),
        ("            const int buf = (tap * PARTS + part) & 1;",
         "            const int buf = PARTS == 1 && tap == 8 ? 2 : (tap * PARTS + part) & 1;"),
        ("        int prev_ws = 0;\n", ""),
        ("    int hi = 0, wi = 0, last_hs = 0;", "    int hi = 0, wi = 0, last_hs = 0, prev_ws = 0;"),
        ("            if (!RESIDENT_W && part == 0 && tap > 0) mbar_arrive(wempty + 8 * prev_ws);",
         "            if (!RESIDENT_W && part == 0 && (tap > 0 || ch > 0))\n"
         "              mbar_arrive(wempty + 8 * prev_ws);"),
        (DRAIN, ""),
        (ITEM_END, "      wgmma_wait<0>();\n      if (!RESIDENT_W) mbar_arrive(wempty + 8 * prev_ws);\n"
                   + ITEM_END),
    ], [  # the clustered kernel, whose stage releases are release_stage's
        ("        uint32_t a[2][SLABS][KS][4];", "        uint32_t a[3][SLABS][KS][4];"),
        ("            const int buf = (tap * PARTS + part) & 1;",
         "            const int buf = PARTS == 1 && tap == 8 ? 2 : (tap * PARTS + part) & 1;"),
        ("        int prev_ws = 0;\n", ""),
        ("    int hi = 0, wi = 0, last_hs = 0;", "    int hi = 0, wi = 0, last_hs = 0, prev_ws = 0;"),
        ("            if (!RESIDENT_W && part == 0 && tap > 0)\n",
         "            if (!RESIDENT_W && part == 0 && (tap > 0 || ch > 0))\n"),
        ("        wgmma_wait<0>();\n"
         "        if (!RESIDENT_W) release_stage<C::CLUSTER>(wempty + 8 * prev_ws, lane);\n", ""),
        (ITEM_END, "      wgmma_wait<0>();\n"
                   "      if (!RESIDENT_W) release_stage<C::CLUSTER>(wempty + 8 * prev_ws, lane);\n"
                   + ITEM_END),
    ]],
}
# The clustered kernel (this checkout's): what its multicast and its
# changes around the store do. None changes a value.
REMOTE_ARRIVE = '"mbarrier.arrive.shared::cluster.b64 _, [remote];\\n}\\n"'
VARIANTS.update({
    # a stage's remote release at cluster scope (release.cluster)
    "release_cluster": [[(REMOTE_ARRIVE, REMOTE_ARRIVE.replace(
        "arrive.shared", "arrive.release.cluster.shared"))]],
    # still clusters, but each CTA loads its whole weight stage itself
    "no_multicast": [[
        ("C::CLUSTER > 1 ? C::CLUSTER * (CONSUMERS / 32) : CONSUMERS / C::RINGS",
         "C::CLUSTER > 1 ? CONSUMERS / 32 : CONSUMERS / C::RINGS"),
        ("    if (lane < CLUSTER) mbar_arrive_cluster(bar, lane);", "    if (lane == 0) mbar_arrive(bar);"),
        ("              if constexpr (C::CLUSTER > 1) {\n                // This CTA's",
         "              if constexpr (C::CLUSTER > 1 && false) {\n                // This CTA's"),
        ("    const cuuint32_t wbox[2] = {CHUNK, BN / C::CLUSTER};", "    const cuuint32_t wbox[2] = {CHUNK, BN};"),
    ]],
    # each storing thread waits for its store's read right after it, as before
    "store_wait": [[("          bulk_store_commit();\n        }\n        continue;",
                     "          bulk_store_wait_read();\n        }\n        continue;")]],
    # the second warpgroup starts 4 taps after the first (a stagger kept by the shared ring)
    "lag4": [[
        ("      bool live = true;", "      bool live = true;"),  # the clustered kernel only
        ("2 * RINGS * W_STAGES + (LAYOUT == PIPES ? 1 : 0);",
         "2 * RINGS * W_STAGES + (LAYOUT == PIPES || CLUSTER > 1 ? 1 : 0);"),
        ("    if (LAYOUT == PIPES) mbar_init(go, 1);", "    if (LAYOUT == PIPES || C::CLUSTER > 1) mbar_init(go, 1);"),
        ("    if (LAYOUT == PIPES && g == 1) mbar_wait(go, 0);\n",
         "    if (LAYOUT == PIPES && g == 1) mbar_wait(go, 0);\n"
         "    if (C::CLUSTER > 1 && wg_in == 1) mbar_wait(go, 0);\n"),
        ("              ch * 9 + tap == go_step)\n            mbar_arrive(go);\n",
         "              ch * 9 + tap == go_step)\n            mbar_arrive(go);\n"
         "          if (C::CLUSTER > 1 && tid == 0 && item == first && ch * 9 + tap == 4)\n"
         "            mbar_arrive(go);\n"),
    ]],
    # the single-CTA kernel's rings: 3 halo stages, 6 weight stages
    "ring_6_3": [[
        ("  static constexpr int H_STAGES = F32 || CLUSTER > 1 ? 2 : 3;",
         "  static constexpr int H_STAGES = F32 ? 2 : 3;"),
        ("RESIDENT_W ? 9 : F32 ? 131072 / W_TILE / RINGS : CLUSTER > 1 ? 8 : 6;",
         "RESIDENT_W ? 9 : F32 ? 131072 / W_TILE / RINGS : 6;"),
    ]],
})
EXACT = ("no_drain", "release_cluster", "no_multicast", "store_wait", "lag4", "ring_6_3")  # same values as as built

# The C <= 64 instance (RESIDENT, layout 1) as it stood before its redesign:
# (label, mode, C, N, input rows, width, pad), as SHAPES. The band rows are
# one rank's band of a 1x2 mesh at 512^2 (the families' inc / up4 site).
RES_SHAPES = [
    ("64@480.fused", "fused", 64, BATCH, 480, 480, (1, 1)),
    ("64@240.fused", "fused", 64, BATCH, 240, 240, (1, 1)),
    ("64@480", "same", 64, BATCH, 480, 480, (1, 1)),
    ("64@512.dgrad", "dgrad", 64, BATCH, 512, 512, (1, 1)),
    ("64@256.dgrad", "dgrad", 64, BATCH, 256, 256, (1, 1)),
    ("64@257x512.band", "same", 64, BATCH, 257, 512, (1, 0)),
    ("64@257x512.band.dgrad", "dgrad", 64, BATCH, 257, 512, (1, 0)),
]
RES_STORE = "            tma_store_4d(&ymap, stage + half * TILE_M * ROW_BYTES"
RES_STORE_BLOCK = """            tma_store_4d(&ymap, stage + half * TILE_M * ROW_BYTES, co_t * BN + half * 64, x0, y0, n);
        bulk_store_wait_read();
      }
      if (C::STAGE_IN_HALO) mbar_arrive(hempty + 8 * last_hs);
    }
  }
"""
RES_VARIANTS = {
    # A's ldmatrix at taps 0 and 1 only (one per register buffer), then reused
    "no_ldsm": [[("                  ldsm_x4(addr, a[buf][s][kk]);",
                  "                  if (tap < 2) ldsm_x4(addr, a[buf][s][kk]);")]],
    # B read once per k step: the second slab's wgmma skipped, its accumulators stored
    "one_slab": [[("                const int ks = part * KS + kk;\n                if constexpr (C::F32) {",
                   "                const int ks = part * KS + kk;\n                if (RESIDENT_W && s > 0) continue;\n"
                   "                if constexpr (C::F32) {")]],
    "no_store": [[(RES_STORE, "            if (p.c < 0)\n" + RES_STORE)]],
    "no_epilogue": VARIANTS["no_epilogue"][1:],
    # the store's read awaited at the next item's epilogue, which then releases the stage
    "store_defer": [[
        ("    int hi = 0, wi = 0, last_hs = 0;", "    int hi = 0, wi = 0, last_hs = 0, deferred = -1;"),
        (EPILOGUE, "\n      if (deferred >= 0) {\n        bulk_store_wait_read_only();\n"
                   "        mbar_arrive(hempty + 8 * deferred);\n        deferred = -1;\n      }" + EPILOGUE),
        (RES_STORE_BLOCK, RES_STORE_BLOCK.replace(
            "        bulk_store_wait_read();\n      }\n      if (C::STAGE_IN_HALO) mbar_arrive",
            "        bulk_store_commit();\n        deferred = last_hs;\n      } else if (C::STAGE_IN_HALO) {\n"
            "        mbar_arrive").replace(
            "(hempty + 8 * last_hs);\n    }\n  }\n",
            "(hempty + 8 * last_hs);\n      }\n    }\n    if (deferred >= 0) {\n"
            "      bulk_store_wait_read_only();\n      mbar_arrive(hempty + 8 * deferred);\n    }\n  }\n"))]],
    # a 2-stage halo ring per group
    "ring2": [[("  static constexpr int H_STAGES = F32 || CLUSTER > 1 ? 2 : 3;",
                "  static constexpr int H_STAGES = 2;")]],
}
RES_EXACT = ("store_defer", "ring2")
# The redesigned C <= 64 kernel (conv3x3_c64_kernel): what its time goes to.
C64_MMA = "        wgmma_m64n256k16_ss<DGRAD ? 1 : 0>(acc, adesc + (DGRAD ? 128 : 2) * ks, bdesc + 2 * ks);"
C64_EPILOGUE = "    // ---- epilogue: (+ bias, ReLU), bf16, transposed per warp, 16-byte stores ----\n"
C64_KEEP_ACC = ("    {\n      float sum = 0.0f;\n      for (int i = 0; i < 128; ++i) sum += acc[i];\n"
                "      if (sum == 1234.5f) __trap();\n      continue;\n    }\n")
C64_VARIANTS = {
    # B's start row rounded down to a multiple of 8: every read aligned to the swizzle's atom
    "aligned_b": [[("smem_desc_sw128(stage + ((tap / 3) * pitch + tap % 3) * ROW_BYTES)",
                    "smem_desc_sw128(stage + (((tap / 3) * pitch + tap % 3) & ~7) * ROW_BYTES)")]],
    # the epilogue's global stores skipped (the transposes kept)
    "no_store": [[("      if (live_c && x < p.tw", "      if (p.c < 0 && live_c && x < p.tw")]],
    # the accumulators kept live, no epilogue
    "no_epilogue": [[(C64_EPILOGUE, C64_KEEP_ACC + C64_EPILOGUE)]],
    # halos loaded for the first pass of the ring only, then re-read as they stand
    "no_load": [[("        mbar_expect_tx(full, p.halo_tx);",
                  "        if (k >= C64_STAGES) {\n          mbar_arrive(full);\n          continue;\n"
                  "        }\n        mbar_expect_tx(full, p.halo_tx);")]],
    # group 1 starts once group 0's first item's MMAs are done
    "lag1": [[("8 * 3 * C64_STAGES + 8;", "8 * 3 * C64_STAGES + 16;"),
              ("    mbar_init(wfull, 1);\n", "    mbar_init(wfull, 1);\n    mbar_init(wfull + 8, 1);\n"),
              ("  mbar_wait(wfull, 0);\n  for (int k = g;", "  mbar_wait(wfull, 0);\n"
                                                        "  if (g == 1) mbar_wait(wfull + 8, 0);\n"
                                                        "  for (int k = g;"),
              ("    wgmma_wait<0>();\n    fence_operands(acc);\n",
               "    wgmma_wait<0>();\n    fence_operands(acc);\n"
               "    if (g == 0 && tid == 0 && k == 0) mbar_arrive(wfull + 8);\n")]],
    # every call on the 30 x 8 tile
    "tile_30": [[("constexpr int C64_TILES[3][2] = {{30, 8}, {40, 6}, {14, 16}};",
                  "constexpr int C64_TILES[3][2] = {{30, 8}, {30, 8}, {30, 8}};")]],
    # one wgmma an item (tap 0, k step 0): the loads, barriers and epilogue alone
    "no_mma": [[(C64_MMA, "        if (tap == 0 && ks == 0)\n  " + C64_MMA)]],
    # the first wgmma of an item overwrites the accumulators (scale-d 0), which are not zeroed
    "scale0": [[
        ("void wgmma_m64n256k16_ss(float (&d)[128], uint64_t adesc,\n"
         "                                                    uint64_t bdesc) {",
         "void wgmma_m64n256k16_ss(float (&d)[128], uint64_t adesc,\n"
         "                                                    uint64_t bdesc, int scale_d) {"),
        ('      : "l"(adesc), "l"(bdesc), "r"(1), "n"(TRANS_A));',
         '      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TRANS_A));'),
        ("(acc, adesc + (DGRAD ? 128 : 2) * ks, bdesc + 2 * ks);",
         "(acc, adesc + (DGRAD ? 128 : 2) * ks, bdesc + 2 * ks, tap + ks > 0);"),
        ("#pragma unroll\n    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;\n", ""),
    ]],
}
C64_EXACT = ("lag1", "tile_30", "scale0")
# The bf16 instances at 64 output channels (mangled).
BF16_64 = "I13__nv_bfloat16Li64"


def _ptxas(log: str, kernel: str = BF16_128) -> list[str]:
    """ptxas's registers and spills for the bf16 instances ``kernel`` (by default the 128-channel
    ones), and any wgmma warning."""
    warn = [line.strip() for line in log.splitlines() if "wgmma" in line and "arn" in line]
    return f32probe._ptxas_f32_64(log, kernel) + warn[:8]


def _ptxas_c64(log: str) -> list[str]:
    """ptxas's lines (registers, spills) for the ``conv3x3_c64_kernel`` instances."""
    lines = log.splitlines()
    return [" | ".join(x.strip() for x in lines[i:i + 4]) for i, line in enumerate(lines)
            if "Compiling entry function" in line and "c64_kernel" in line]


def _bound_ms(c: int, n: int, oh: int, w: int, in_rows: int) -> float:
    """The larger of the operations at the bf16 peak and the bytes (input, output, weights) at HBM's rate."""
    flops = 2.0 * 9 * c * c * n * oh * w
    nbytes = 2.0 * (n * c * (in_rows + oh) * w + 9 * c * c)
    return max(flops / PEAK_BF16, nbytes / HBM) * 1e3


def _case(mode: str, c: int, n: int, h: int, w: int, pad, seed: int):
    """(kernel call, library call, output rows, input rows) of one bf16 call."""
    from unet_embroidery_seg_torch.ops import conv3x3 as C

    fn = f32probe._calls(c, n, h, w, pad, seed, torch.bfloat16)[mode]
    x, g, wt, b = f32probe._inputs(c, n, h, w, seed)
    wd, bd = wt.to(torch.bfloat16), b.to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    padding = 1 if tuple(pad) == (1, 1) else (0, 1)
    oh = C.out_rows(h, pad)
    if mode == "dgrad":
        gd = g.to(torch.bfloat16)[:, :, :oh].contiguous(memory_format=torch.channels_last)
        # cuDNN's dgrad on the band's own rows, as chip_smoke.py times it
        return (fn, lambda: torch.nn.grad.conv2d_input(gd.shape, wd, gd, padding=1), h, oh)
    if mode == "fused":
        return fn, lambda: F.conv2d(x, wd, bd, padding=padding), oh, h
    return fn, lambda: F.conv2d(x, wd, padding=padding), oh, h


TOL_BF16 = 2.0 ** -7  # of the largest value: one bf16 ulp (chip_smoke.py's)


def _plain(mode: str, c: int, n: int, h: int, w: int, pad, seed: int) -> torch.Tensor:
    """The plain PyTorch version of ``_case``'s call on the same inputs."""
    from unet_embroidery_seg_torch.ops import conv3x3 as C

    x, g, wt, b = f32probe._inputs(c, n, h, w, seed)
    x = x.to(torch.bfloat16)
    if mode == "dgrad":
        gd = g.to(torch.bfloat16)[:, :, :C.out_rows(h, pad)].contiguous(
            memory_format=torch.channels_last)
        return C.conv3x3_dgrad_plain(gd, wt, C.dgrad_pad(pad))
    if mode == "fused":
        return C.conv3x3_bias_relu_plain(x, wt, b, pad)
    return C.conv3x3_same_plain(x, wt, pad)


def _library_ms(fn) -> float:
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    return graph_ms(fn, event_ms(fn))


def split(root: Path, layout: str = "streamed", only: list[str] | None = None) -> dict:
    _build = f32probe._setup()
    text = (root / "unet_embroidery_seg_torch" / "csrc" / "conv3x3_same.cu").read_text()
    resident = layout in ("resident", "c64")
    variants, shapes, exact = {"resident": (RES_VARIANTS, RES_SHAPES, RES_EXACT),
                               "c64": (C64_VARIANTS, RES_SHAPES, C64_EXACT),
                               "streamed": (VARIANTS, SHAPES, EXACT)}[layout]
    sources, skipped = {"as_built": text}, []
    for name, alternatives in variants.items():
        if only and name not in only:
            continue
        for edits in alternatives:
            if all(text.count(old) == 1 for old, _ in edits):
                src = text
                for old, new in edits:
                    src = src.replace(old, new)
                sources[name] = src
                break
        else:
            skipped.append(name)
    libs, logs = f32probe._compile(_build, sources, OUT)
    cdlls = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    out = {"card": f32probe.card(), "root": str(root), "layout": layout, "skipped": skipped,
           "ptxas": {k: _ptxas(v, BF16_64 if resident else BF16_128) + _ptxas_c64(v)
                     for k, v in logs.items()},
           "shapes": {}}
    print("split_build " + json.dumps(out), flush=True)
    names = [k for k in sources if k != "as_built"]
    order = ["as_built", *names, *reversed(names), "as_built"]
    for i, (label, mode, c, n, h, w, pad) in enumerate(shapes):
        fn, library, oh, in_rows = _case(mode, c, n, h, w, pad, seed=i)
        f32probe._use(_build, cdlls["as_built"])
        want = fn()
        equal = {}
        for name in (k for k in exact if k in cdlls):
            f32probe._use(_build, cdlls[name])
            equal[name] = torch.equal(fn(), want)
        del want
        for name in names:  # one synchronised call each first: a fault names its variant
            f32probe._use(_build, cdlls[name])
            fn()
            torch.cuda.synchronize()
            print(f"split_ran {label} {name}", flush=True)
        ms = f32probe._time(_build, cdlls, order, fn)
        base = sum(ms["as_built"]) / 2
        bound = _bound_ms(c, n, oh, w, in_rows)
        row = {"shape": label, "mode": mode, "c": c, "n": n, "out": [oh, w], "pad": list(pad),
               "bound_ms": bound, "library_ms": _library_ms(library),
               "equal_to_as_built": equal, "ms": ms,
               "share_of_bound": {k: bound / (sum(v) / len(v)) for k, v in ms.items()},
               "saved_vs_as_built": {k: 1 - (sum(v) / len(v)) / base for k, v in ms.items()}}
        out["shapes"][label] = row
        print("split_shape " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    f32probe._use(_build, ctypes.CDLL(str(_build.library_path("conv3x3_same"))))
    return out


ROOT_CASES = [  # (label, C, N, H, W, pad, timed)
    ("128@240", 128, 8, 240, 240, (1, 1), True), ("256@120", 256, 8, 120, 120, (1, 1), True),
    ("512@60", 512, 8, 60, 60, (1, 1), True), ("1024@30", 1024, 8, 30, 30, (1, 1), True),
    ("128@120", 128, 8, 120, 120, (1, 1), True), ("512@30", 512, 8, 30, 30, (1, 1), True),
    ("128@256", 128, 8, 256, 256, (1, 1), True), ("256@128", 256, 8, 128, 128, (1, 1), True),
    ("512@64", 512, 8, 64, 64, (1, 1), True), ("1024@32", 1024, 8, 32, 32, (1, 1), True),
    ("512@32.band0", 512, 8, 17, 32, (1, 0), True), ("1024@32.band0", 1024, 8, 17, 32, (1, 0), True),
    ("256@64.band0", 256, 8, 33, 64, (1, 0), True), ("128@128.band0", 128, 8, 65, 128, (1, 0), True),
    ("128@256.band0", 128, 8, 129, 256, (1, 0), True),
    ("512@32.band1", 512, 8, 17, 32, (0, 1), False), ("1024@32.band1", 1024, 8, 17, 32, (0, 1), False),
    ("80@33x47", 80, 2, 33, 47, (1, 1), False), ("80@33x47.pad12", 80, 1, 33, 47, (1, 2), False),
    ("192@20x37.b1", 192, 1, 20, 37, (1, 1), False), ("128@19x45.pad10", 128, 1, 19, 45, (1, 0), False),
    ("1024@9x13.b1", 1024, 1, 9, 13, (1, 1), False), ("256@30x30.pad01", 256, 8, 30, 30, (0, 1), False),
    ("384@15x23.pad12", 384, 3, 15, 23, (1, 2), False), ("128@1x8.b1", 128, 1, 1, 8, (1, 1), False),
]


# The C <= 64 path (``c64_persistent``): the probe's shapes timed, then the
# other pads, C = 16, 32, 48, ragged widths, batch 1.
RES_ROOT_CASES = [  # (label, C, N, H, W, pad, timed)
    ("64@480", 64, 8, 480, 480, (1, 1), True), ("64@240", 64, 8, 240, 240, (1, 1), True),
    ("64@512", 64, 8, 512, 512, (1, 1), True), ("64@256", 64, 8, 256, 256, (1, 1), True),
    ("64@257x512.band0", 64, 8, 257, 512, (1, 0), True),
    ("64@257x512.band1", 64, 8, 257, 512, (0, 1), False),
    ("48@96x72", 48, 2, 96, 72, (1, 1), False), ("32@33x47", 32, 3, 33, 47, (1, 1), False),
    ("16@41x24.band0", 16, 2, 41, 24, (1, 0), False), ("64@33x47.pad12", 64, 2, 33, 47, (1, 2), False),
    ("64@19x13.pad21", 64, 1, 19, 13, (2, 1), False), ("64@20x37.pad02", 64, 1, 20, 37, (0, 2), False),
    ("64@1x8.b1", 64, 1, 1, 8, (1, 1), False), ("16@3x3.b1", 16, 1, 3, 3, (1, 1), False),
]
# Mangled-name parts of the kernels a layout's redesign may change: the bf16
# streamed instances; the bf16 C <= 64 ones (the generic kernel's RESIDENT
# layout, 1, and the kernel that replaced it).
CHANGED = {"streamed": (BF16_128 + "ELi0E",),
           "resident": (BF16_64 + "ELi1E", "conv3x3_c64_kernel")}


def compare_root(root: Path, layout: str = "streamed") -> dict:
    _build = f32probe._setup()
    csrc = "unet_embroidery_seg_torch/csrc/conv3x3_same.cu"
    libs, logs = f32probe._compile(_build, {"root": (root / csrc).read_text(),
                                            "this": (ROOT / csrc).read_text()}, OUT)
    this = ctypes.CDLL(str(_build.library_path("conv3x3_same")))
    pair = {"root": ctypes.CDLL(str(libs["root"])), "this": this}
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_path

    resident = layout in ("resident", "c64")
    layout = "resident" if resident else layout
    same = f32probe._same_code(libs["root"], libs["this"])
    changed = [k for k in same["differ"] + same["only_root"] + same["only_this"]]
    out = {"card": f32probe.card(), "root": str(root), "layout": layout,
           "path": conv3x3_path(64 if resident else 128, torch.bfloat16),
           "ptxas": {k: _ptxas(v, BF16_64 if resident else BF16_128) + _ptxas_c64(v)
                     for k, v in logs.items()},
           "same_code": same,
           # every kernel that differs is one of the layout's
           "other_kernels_identical": all(any(part in k for part in CHANGED[layout])
                                          for k in changed),
           "cases": []}
    print("root_build " + json.dumps(out), flush=True)
    for i, (label, c, n, h, w, pad, timed) in enumerate(RES_ROOT_CASES if resident else ROOT_CASES):
        for mode in ("fused", "same", "dgrad"):
            fn, library, oh, in_rows = _case(mode, c, n, h, w, pad, seed=i)
            f32probe._use(_build, pair["root"])
            a = fn()
            f32probe._use(_build, pair["this"])
            b = fn()
            row = {"case": label, "mode": mode, "shape": [n, c, h, w], "pad": list(pad),
                   "equal": torch.equal(a, b), "max_abs_diff": (a.float() - b.float()).abs().max().item()}
            if resident:  # this checkout's kernel against the plain version, within TOL_BF16
                want = _plain(mode, c, n, h, w, pad, seed=i).float()
                row["max_abs_err"] = (b.float() - want).abs().max().item()
                row["tol"] = TOL_BF16 * want.abs().max().item()
                row["within_tol"] = row["max_abs_err"] <= row["tol"]
                del want
            del a, b
            if timed:
                ms = f32probe._time(_build, pair, ["root", "this", "this", "root"], fn)
                bound = _bound_ms(c, n, oh, w, in_rows)
                row.update({"ms": ms, "bound_ms": bound, "library_ms": _library_ms(library),
                            "share_of_bound": {k: bound / (sum(v) / 2) for k, v in ms.items()}})
            out["cases"].append(row)
            print("root_case " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    f32probe._use(_build, this)
    out["all_equal"] = all(r["equal"] for r in out["cases"])
    if resident:
        out["all_within_tol"] = all(r["within_tol"] for r in out["cases"])
        out["max_abs_diff"] = max(r["max_abs_diff"] for r in out["cases"])
    return out


def _wgmma_n256_ss() -> str:
    """The inline asm of ``wgmma.mma_async m64n256k16`` (bf16, f32 accumulators), A and B by descriptor."""
    regs = ", ".join(f"%{i}" for i in range(128))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(128))
    return (
        "template <int TRANS_A>\n"
        "__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t adesc, uint64_t bdesc) {\n"
        "  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %130, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {{{regs}}}, "\n'
        '      "%128, %129, p, 1, 1, %131, 0;\\n}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(adesc), "l"(bdesc), "r"(1), "n"(TRANS_A));\n'
        "}\n")


# One warpgroup: the halo stage (SHIFT_ROWS rows of 128 bytes, 64 bf16 channels)
# and a 64 x 64 weight tile are written to shared memory with TMA's 128-byte
# swizzle (16-byte unit u of row r at r * 128 + (u ^ r % 8) * 16, from a
# 1024-byte aligned base), then D = A B over one 64-channel chunk in four k16
# steps: A the weights (TRANS_A 0: row m holds K; 1: row k holds M, read
# transposed), B the halo's rows shift .. shift + 255 (K-major, 32 bytes on
# per k16 step). BASE: the B descriptor's base-offset field (bits 49-51) set
# to the start address's row phase. D goes out in wgmma's fragment order.
SHIFT_ROWS = 384
SHIFT_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int base) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
               (1ull << 62);
  if (base) d |= static_cast<uint64_t>((addr >> 7) & 7) << 49;
  return d;
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(8192 >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

WGMMA

template <int TRANS_A, int BASE>
__global__ void __launch_bounds__(128) shift_kernel(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                                    float* out, int shift) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* halo = smem_raw + (base - raw);
  uint8_t* wt = halo + ROWS * 128;
  const int tid = threadIdx.x;
  for (int e = tid; e < ROWS * 8; e += 128) {
    const int r = e / 8, u = e % 8;
    *reinterpret_cast<uint4*>(halo + r * 128 + ((u ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(x + r * 64 + u * 8);
  }
  for (int e = tid; e < 64 * 8; e += 128) {
    const int r = e / 8, u = e % 8;
    *reinterpret_cast<uint4*>(wt + r * 128 + ((u ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(w + r * 64 + u * 8);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t a = TRANS_A ? desc_mn(base + ROWS * 128) + 128 * ks
                               : desc_k(base + ROWS * 128, 0) + 2 * ks;
    wgmma_n256<TRANS_A>(d, a, desc_k(base + shift * 128, BASE) + 2 * ks);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        out[(16 * warp + lane / 4 + 8 * h) * 256 + 8 * j + 2 * (lane % 4) + v] = d[4 * j + 2 * h + v];
}

template <int TRANS_A, int BASE>
int run(const void* x, const void* w, void* out, int shift) {
  constexpr int SMEM = 1024 + (ROWS + 64) * 128;
  cudaError_t e = cudaFuncSetAttribute(shift_kernel<TRANS_A, BASE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  shift_kernel<TRANS_A, BASE><<<1, 128, SMEM>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const __nv_bfloat16*>(w),
                                                static_cast<float*>(out), shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int shift_launch(const void* x, const void* w, void* out, int shift, int trans_a,
                            int base) {
  if (shift < 0 || shift + 256 > ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (trans_a) return base ? run<1, 1>(x, w, out, shift) : run<1, 0>(x, w, out, shift);
  return base ? run<0, 1>(x, w, out, shift) : run<0, 0>(x, w, out, shift);
}
"""


def shift_check() -> dict:
    """The shifted-B descriptor of the C <= 64 kernel against the same product in f32."""
    _build = f32probe._setup()
    src = SHIFT_SOURCE.replace("WGMMA", _wgmma_n256_ss()).replace("ROWS", str(SHIFT_ROWS))
    libs, logs = f32probe._compile(_build, {"shift": src}, OUT)
    fn = ctypes.CDLL(str(libs["shift"])).shift_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-4, 5, (SHIFT_ROWS, 64), generator=gen).to(torch.bfloat16).cuda()
    w = torch.randint(-4, 5, (64, 64), generator=gen).to(torch.bfloat16).cuda()
    out = {"card": f32probe.card(), "ptxas": [line for line in logs["shift"].splitlines()
                                             if "registers" in line or "spill" in line], "cases": []}
    for trans_a in (0, 1):
        a = (w.float().t() if trans_a else w.float())  # [m][k]
        for base in (0, 1):
            for shift in (0, 1, 2, 5, 7, 8, 9, 33, 66, 127, 128):
                d = torch.full((64, 256), float("nan"), device="cuda")
                code = fn(x.data_ptr(), w.data_ptr(), d.data_ptr(), shift, trans_a, base)
                torch.cuda.synchronize()
                want = a @ x.float()[shift:shift + 256].t()
                row = {"trans_a": trans_a, "base_offset": base, "shift": shift, "code": code,
                       "equal": code == 0 and torch.equal(d, want),
                       "max_abs_diff": (d - want).abs().max().item() if code == 0 else None}
                out["cases"].append(row)
                print("shift_case " + json.dumps(row), flush=True)
    out["works"] = {f"trans_a={t},base_offset={b}": all(
        r["equal"] for r in out["cases"] if (r["trans_a"], r["base_offset"]) == (t, b))
        for t in (0, 1) for b in (0, 1)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("split", "root", "shift"))
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose kernel `split` varies or `root` compares")
    parser.add_argument("--variants", default="",
                        help="split: a comma-separated subset of the layout's variants")
    parser.add_argument("--layout", choices=("streamed", "resident", "c64"), default="streamed",
                        help="split: the C > 64 instance (streamed), the C <= 64 one as it stood "
                             "before its redesign (resident) or after (c64); root: the C > 64 path "
                             "(streamed) or the C <= 64 one (resident or c64)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_bf16_probe: no CUDA device available", file=sys.stderr)
        return 1
    with torch.no_grad():  # the wrappers' packed-weight cache: each timed call is the kernel's
        if args.what == "split":
            result = split(args.root.resolve(), args.layout,
                           [v for v in args.variants.split(",") if v])
        elif args.what == "shift":
            result = shift_check()
        else:
            result = compare_root(args.root.resolve(), args.layout)
    print(json.dumps({args.what: result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
