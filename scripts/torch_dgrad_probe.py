#!/usr/bin/env python3
"""conv3x3's dgrad on the forward's packing: two measurements beside ``chip_smoke.py``'s, on one card.

    python scripts/torch_dgrad_probe.py peak [--root DIR]   # a checkout's unet_plain step
    python scripts/torch_dgrad_probe.py tile                # the halo dgrad's tile at 1024@16x32

``peak``: unet_plain's train step at 512^2, batch 8, BCE, through
``chip_smoke.train_path`` of the checkout at ``--root`` (default: this
one): 5 bf16 steps and 3 f32 (``--no-amp``) steps, each after a warm-up
step, with the peak memory (``torch.cuda.max_memory_allocated``) and the
median ms/step. Run it on an older checkout and on this one in turns
(parent, change, change, parent) in one call to see what holding the
grad-mode packing to the backward costs in memory. Each checkout builds
its own kernels under its own ``build/``.

``tile``: the halo dgrad of unet_plain's ``down4`` band (1024 channels, 16
rows of width 32, dgrad pads (1, 2): 17 output rows), bf16 and f32, with
``pick_tile`` as built and with a 7-wide tile added to its choices (7 x 18,
which covers the 17 rows in one tile row), timed in turns by graph replay
and held to the plain version.

Prints one JSON line per result. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def peak(root: Path) -> dict:
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke as cs
    from unet_embroidery_seg_torch.ops import _build
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_dgrad, conv3x3_same
    from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_backward

    _build.build(["upsample2x", "upsample2x_bwd", "conv3x3_same"])
    counters = [upsample2x, upsample2x_backward, conv3x3_same, conv3x3_dgrad]
    per_step = {"upsample2x": 4, "upsample2x_backward": 4, "conv3x3_same": 9, "conv3x3_dgrad": 9}
    out = {"root": str(root), "card": card()}
    for key, amp, steps in (("bf16", True, 5), ("f32", False, 3)):
        r = cs.train_path(counters, "unet_plain", "bce", steps, per_step, amp=amp, checks=False)
        out[key] = {"peak_mem_gb": r["peak_mem_gb"], "step_ms_median": r["step_ms_median"],
                    "step_ms": r["step_ms"]}
        torch.cuda.empty_cache()
    return out


def tile() -> dict:
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from unet_embroidery_seg_torch.ops import _build
    from unet_embroidery_seg_torch.ops import conv3x3 as C
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    _build.build(["conv3x3_same"])
    src = (_build.CSRC / "conv3x3_same.cu").read_text()
    choices = "const int tws[3] = {8, 16, 30};"
    if choices not in src:
        raise RuntimeError("pick_tile's tile widths are not where this probe expects them")
    variant = ROOT / "build" / "tile_probe" / "conv3x3_same_tw7.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(src.replace(choices, "const int tws[4] = {7, 8, 16, 30};"))
    lib = variant.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(variant)], check=True)
    libs = {"as_built": ctypes.CDLL(str(_build.library_path("conv3x3_same"))),
            "tw7": ctypes.CDLL(str(lib))}
    gen = torch.Generator().manual_seed(0)
    out = {"card": card(), "shape": [8, 1024, 16, 32], "pad": [1, 2]}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.randn(8, 1024, 16, 32, generator=gen).to("cuda", dtype).contiguous(
            memory_format=torch.channels_last)
        w = (torch.randn(1024, 1024, 3, 3, generator=gen) / 96.0).cuda().contiguous(
            memory_format=torch.channels_last)
        packed = C.pack_conv3x3_grad(w, dtype)
        want = C.conv3x3_dgrad_plain(g, w, (1, 2)).float()

        def run():
            return C.conv3x3_dgrad(g, w, (1, 2), packed)

        rows = {}
        for name in ("as_built", "tw7", "tw7", "as_built"):
            _build._libs["conv3x3_same"] = libs[name]
            _build._fns.clear()
            err = (run().float() - want).abs().max().item() / want.abs().max().item()
            rows.setdefault(name, []).append({"ms": graph_ms(run, event_ms(run)), "rel_err": err})
        out[str(dtype)] = rows
    _build._libs["conv3x3_same"] = libs["as_built"]
    _build._fns.clear()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("peak", "tile"))
    parser.add_argument("--root", type=Path, default=ROOT, help="checkout for `peak`")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dgrad_probe: no CUDA device available", file=sys.stderr)
        return 1
    result = peak(args.root.resolve()) if args.what == "peak" else tile()
    print(json.dumps({args.what: result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
