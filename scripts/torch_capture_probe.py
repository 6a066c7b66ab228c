#!/usr/bin/env python3
"""When a bf16 forward + backward loses its CUDA-graph capture, on one CUDA card.

    python scripts/torch_capture_probe.py [--only SUBSTRING]

``chip_smoke.py`` phase 18a times unet_resnet50's final stage (``up_conv``:
64 channels at 256^2 upsampled to 512^2, two fused 3x3 convs, the 1x1
head; batch 8), unpacked (the port's kernels) and packed (the test
reference in ``tests/torch_alternates.py``), by CUDA-graph replay
(``utils/timing.graph_ms``), f32 (TF32 off) and under bf16 autocast (cast
cache off). Each case below runs in a fresh process, warms its calls up
as ``utils/timing.event_ms`` does, then captures them as ``graph_ms``
does, and reports for each capture whether it held:

- each op of the stage alone under bf16 autocast, forward + backward (the
  upsample and conv wrappers, the 1x1 head, the packed tail's ops), and
  both stages whole;
- the stages in phase 18a's order (f32 then bf16) and in others (bf16
  only, bf16 then f32, one stage only, no grad-off forward captured);
- one bf16 op alone after the f32 unpacked stage's forward + backward was
  captured, to name the op that loses the capture; the same op captured
  twice, or with the allocator's cache emptied or the garbage collected
  first, to find what clears it.

``--only SUBSTRING`` runs the cases whose name holds it.

Prints one JSON line per case, ``{"case": ..., "captured": {capture:
true or false}}``, then one JSON object of every case as its last line.
Needs a card and the port's kernels (built once, before the cases).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

C, H, N, CLASSES = 64, 256, 8, 2
OPS = ("upsample2x", "conv3x3_bias_relu", "head", "packed_upsample2x", "packed_conv3x3",
       "packed_conv1x1")
# name -> (steps: (dtype, stage or op, grad-off forward first[, what to do before]), ...)
CASES = {
    **{f"bf16 {op} alone": (("bf16", op, False),) for op in OPS},
    "bf16 unpacked stage alone": (("bf16", "unpacked", False),),
    "bf16 packed stage alone": (("bf16", "packed", False),),
    "as 18a: f32 then bf16, packed then unpacked": (
        ("f32", "packed", True), ("f32", "unpacked", True),
        ("bf16", "packed", True), ("bf16", "unpacked", True)),
    "as 18a, no grad-off forward": (
        ("f32", "packed", False), ("f32", "unpacked", False),
        ("bf16", "packed", False), ("bf16", "unpacked", False)),
    "bf16 only": (("bf16", "packed", True), ("bf16", "unpacked", True)),
    "bf16 then f32": (("bf16", "packed", True), ("bf16", "unpacked", True),
                      ("f32", "packed", True), ("f32", "unpacked", True)),
    "unpacked only: f32 then bf16": (("f32", "unpacked", True), ("bf16", "unpacked", True)),
    **{f"f32 unpacked stage, then bf16 {op}": (("f32", "unpacked", False), ("bf16", op, False))
       for op in ("upsample2x", "conv3x3_bias_relu", "head")},
    # what clears it: the same bf16 capture twice, or the allocator's cache
    # emptied (or Python's garbage collected) before it
    "f32 unpacked stage, then bf16 upsample2x twice": (
        ("f32", "unpacked", False), ("bf16", "upsample2x", False), ("bf16", "upsample2x", False)),
    "f32 unpacked stage, empty_cache, then bf16 upsample2x": (
        ("f32", "unpacked", False), ("bf16", "upsample2x", False, "empty_cache")),
    "f32 unpacked stage, gc, then bf16 upsample2x": (
        ("f32", "unpacked", False), ("bf16", "upsample2x", False, "gc")),
}


def run_case(name: str) -> dict:
    """One case's steps in this process: {capture name: whether its graph held}."""
    import torch_alternates as alt
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
    from unet_embroidery_seg_torch.ops.upsample import upsample2x
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(181)
    dev = torch.device("cuda")
    x0 = torch.relu(torch.randn(N, C, H, H, generator=gen)).to(dev)
    x0 = x0.contiguous(memory_format=torch.channels_last)
    p = {"w1": torch.randn(C, C, 3, 3, generator=gen) / (3 * C ** 0.5),
         "b1": 0.1 * torch.randn(C, generator=gen),
         "w2": torch.randn(C, C, 3, 3, generator=gen) / (3 * C ** 0.5),
         "b2": 0.1 * torch.randn(C, generator=gen),
         "wh": torch.randn(CLASSES, C, 1, 1, generator=gen) / C ** 0.5,
         "bh": 0.1 * torch.randn(CLASSES, generator=gen)}
    p = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
    gy = torch.randn(N, CLASSES, 2 * H, 2 * H, generator=gen).to(dev)
    u0 = upsample2x(x0, True).detach()
    g_up = torch.randn(u0.shape, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)

    def unpacked(x):
        y = conv3x3_bias_relu(upsample2x(x, True), p["w1"], p["b1"])
        y = conv3x3_bias_relu(y, p["w2"], p["b2"])
        return F.conv2d(y, p["wh"], p["bh"])

    def packed(x):
        y = F.relu(alt.packed_conv3x3(alt.packed_upsample2x(x, True), p["w1"], p["b1"]))
        y = F.relu(alt.packed_conv3x3(y, p["w2"], p["b2"]))
        return alt.depth_to_space2(alt.packed_conv1x1(y, p["wh"], p["bh"]))

    def step(dtype_name: str, what: str):
        """(forward, its inputs, their output gradient) of a stage or an op."""
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x = x0.to(dtype).requires_grad_(True)
        u = u0.to(dtype).requires_grad_(True)
        pu = alt.space_to_depth2(u.detach()).requires_grad_(True)
        g = gy.to(dtype)
        return {
            "unpacked": (lambda: unpacked(x), [x, *p.values()], g),
            "packed": (lambda: packed(x), [x, *p.values()], g),
            "upsample2x": (lambda: upsample2x(x, True), [x], g_up.to(dtype)),
            "conv3x3_bias_relu": (lambda: conv3x3_bias_relu(u, p["w1"], p["b1"]),
                                  [u, p["w1"], p["b1"]], g_up.to(dtype)),
            "head": (lambda: F.conv2d(u, p["wh"], p["bh"]), [u, p["wh"], p["bh"]], g),
            "packed_upsample2x": (lambda: alt.packed_upsample2x(x, True), [x],
                                  alt.space_to_depth2(g_up.to(dtype))),
            "packed_conv3x3": (lambda: alt.packed_conv3x3(pu, p["w1"], p["b1"]),
                               [pu, p["w1"], p["b1"]], alt.space_to_depth2(g_up.to(dtype))),
            "packed_conv1x1": (lambda: alt.packed_conv1x1(pu, p["wh"], p["bh"]),
                               [pu, p["wh"], p["bh"]], alt.space_to_depth2(g)),
        }[what], dtype == torch.bfloat16

    def held(fn) -> bool:
        probe = event_ms(fn)
        try:
            graph_ms(fn, probe)
            return True
        except RuntimeError as e:
            if "StreamCaptureInvalidated" not in str(e):
                raise
            torch.cuda.synchronize()
            return False

    captured = {}
    for k, (dtype_name, what, grad_off_first, *before) in enumerate(CASES[name]):
        if before == ["empty_cache"]:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        elif before == ["gc"]:
            gc.collect()
        (f, inputs, g), amp = step(dtype_name, what)
        seen = {(d, w) for d, w, *_ in CASES[name][:k]}
        tag = f"{dtype_name} {what}" + (f" ({k + 1})" if (dtype_name, what) in seen else "")

        def fwd(f=f, amp=amp):
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp, cache_enabled=False):
                return f()

        if grad_off_first:
            with torch.no_grad():
                captured[f"{tag} forward"] = held(fwd)
        captured[f"{tag} forward + backward"] = held(
            lambda fwd=fwd, inputs=inputs, g=g: torch.autograd.grad(fwd(), inputs, g))
    return captured


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--case":  # one case, in its own process
        print(json.dumps({"case": sys.argv[2], "captured": run_case(sys.argv[2])}), flush=True)
        return 0
    only = sys.argv[2] if len(sys.argv) > 2 and sys.argv[1] == "--only" else ""
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from unet_embroidery_seg_torch.ops import _build

    _build.build(["upsample2x", "upsample2x_bwd", "conv3x3_same"])
    results = {}
    for name in (n for n in CASES if only in n):
        proc = subprocess.run([sys.executable, __file__, "--case", name], capture_output=True,
                              text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"case"')]
        if proc.returncode or not lines:
            results[name] = {"error": proc.stderr.strip()[-300:]}
            print(json.dumps({"case": name, **results[name]}), flush=True)
            continue
        print(lines[-1], flush=True)
        results[name] = json.loads(lines[-1])["captured"]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
