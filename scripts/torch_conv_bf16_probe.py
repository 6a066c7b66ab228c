#!/usr/bin/env python3
"""conv3x3's bf16 streamed kernel (``wgmma``, C > 64): what holds it back, and a checkout against this one.

    python scripts/torch_conv_bf16_probe.py split [--root DIR]   # timing-only variants of a kernel
    python scripts/torch_conv_bf16_probe.py root --root DIR      # DIR's kernel against this one's

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
held bit for bit against the kernel as built. A variant whose kernel text is not in the source is skipped (``skipped``).
Each source is built into ``build/conv_bf16_probe/`` with ``nvcc -Xptxas -v``
(all at once) and timed by graph replay in turns: as built, every variant,
every variant again in reverse, as built. Also printed: ptxas's registers,
spills and warnings for the bf16 instances at 128 output channels.

``root``: ``--root``'s ``conv3x3_same.cu`` (an older checkout, unpacked with
``git archive``) against this checkout's, both through this checkout's
wrappers (the C interface and the weight packing are the same), at every
streamed case of ``ROOT_CASES``: the fused forward, the bias-free forward
and dgrad at SAME and halo pads ((1, 0), (0, 1); dgrad (1, 2), (2, 1)),
C = 80 and 128-1024, ragged widths, batch 1 and 8. The two outputs are
compared bit for bit on the same seeded inputs; the ``timed`` cases are
timed in turns (root, this, this, root) beside one PyTorch call of the same
function (``F.conv2d``; dgrad ``conv2d_input``). ``same_code`` lists the
kernels the two sources compile to the same SASS (``cuobjdump``) and those
that differ or exist in one only.

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


def _ptxas(log: str) -> list[str]:
    """ptxas's registers and spills for the bf16 128-channel instances, and any wgmma warning."""
    warn = [line.strip() for line in log.splitlines() if "wgmma" in line and "arn" in line]
    return f32probe._ptxas_f32_64(log, BF16_128) + warn[:8]


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


def _library_ms(fn) -> float:
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    return graph_ms(fn, event_ms(fn))


def split(root: Path) -> dict:
    _build = f32probe._setup()
    text = (root / "unet_embroidery_seg_torch" / "csrc" / "conv3x3_same.cu").read_text()
    sources, skipped = {"as_built": text}, []
    for name, alternatives in VARIANTS.items():
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
    out = {"card": f32probe.card(), "root": str(root), "skipped": skipped,
           "ptxas": {k: _ptxas(v) for k, v in logs.items()}, "shapes": {}}
    print("split_build " + json.dumps(out), flush=True)
    names = [k for k in sources if k != "as_built"]
    order = ["as_built", *names, *reversed(names), "as_built"]
    for i, (label, mode, c, n, h, w, pad) in enumerate(SHAPES):
        fn, library, oh, in_rows = _case(mode, c, n, h, w, pad, seed=i)
        f32probe._use(_build, cdlls["as_built"])
        want = fn()
        equal = {}
        for name in (k for k in EXACT if k in cdlls):
            f32probe._use(_build, cdlls[name])
            equal[name] = torch.equal(fn(), want)
        del want
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


def compare_root(root: Path) -> dict:
    _build = f32probe._setup()
    csrc = "unet_embroidery_seg_torch/csrc/conv3x3_same.cu"
    libs, logs = f32probe._compile(_build, {"root": (root / csrc).read_text(),
                                            "this": (ROOT / csrc).read_text()}, OUT)
    this = ctypes.CDLL(str(_build.library_path("conv3x3_same")))
    pair = {"root": ctypes.CDLL(str(libs["root"])), "this": this}
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_path

    same = f32probe._same_code(libs["root"], libs["this"])
    out = {"card": f32probe.card(), "root": str(root), "path": conv3x3_path(128, torch.bfloat16),
           "ptxas": {k: _ptxas(v) for k, v in logs.items()}, "same_code": same,
           # every kernel that differs is a bf16 streamed instance
           "other_kernels_identical": all(BF16_128 + "ELi0E" in k
                                          for k in same["differ"] + same["only_root"]
                                          + same["only_this"]),
           "cases": []}
    print("root_build " + json.dumps(out), flush=True)
    for i, (label, c, n, h, w, pad, timed) in enumerate(ROOT_CASES):
        for mode in ("fused", "same", "dgrad"):
            fn, library, oh, in_rows = _case(mode, c, n, h, w, pad, seed=i)
            f32probe._use(_build, pair["root"])
            a = fn()
            f32probe._use(_build, pair["this"])
            b = fn()
            row = {"case": label, "mode": mode, "shape": [n, c, h, w], "pad": list(pad),
                   "equal": torch.equal(a, b), "max_abs_diff": (a.float() - b.float()).abs().max().item()}
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
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("split", "root"))
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose kernel `split` varies or `root` compares")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_bf16_probe: no CUDA device available", file=sys.stderr)
        return 1
    with torch.no_grad():  # the wrappers' packed-weight cache: each timed call is the kernel's
        result = {"split": split, "root": compare_root}[args.what](args.root.resolve())
    print(json.dumps({args.what: result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
