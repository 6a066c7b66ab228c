#!/usr/bin/env python3
"""Which autograd forward + backward loses its CUDA-graph capture, on one CUDA card.

    python scripts/torch_capture_probe.py [--only SUBSTRING ...]

``chip_smoke.py`` phase 18a times unet_resnet50's final stage (``up_conv``:
64 channels at 256^2 upsampled to 512^2, two fused 3x3 convs, the 1x1
head; batch 8), unpacked (the port's kernels) and packed (the test
reference in ``tests/torch_alternates.py``), by CUDA-graph replay
(``utils/timing.graph_ms``), f32 (TF32 off) and under bf16 autocast (cast
cache off). Each case below runs in a fresh process, warms its calls up
as ``utils/timing.event_ms`` does, then captures them as ``graph_ms``
does, and reports for each capture whether it held.

The cause it found: a backward that reaches an input's ``grad_fn`` made
outside the capture on another stream (the eager one) loses the capture.
At the end of the backward autograd joins that node's stream to the
capturing stream by an event recorded outside the capture, and a captured
wait on such an event invalidates the capture. 18a made each dtype's
input as ``x0.to(dtype).requires_grad_(True)``; in f32 that is ``x0``
itself, so the f32 step left ``x0`` requiring grad and every later input
made from it a non-leaf (``ToCopyBackward0``) made on the eager stream.
So a bf16 capture "after an f32 one" was lost, whatever the op. Steps
make each input a leaf copy (``inputs="copy"``, the default, as 18a does
now); ``"alias"`` makes it as 18a did, ``"nonleaf"`` makes ``x0`` and
``u0`` require grad first. The cases:

- each op of the stage alone under bf16 autocast, forward + backward (the
  upsample and conv wrappers, the 1x1 head, the packed tail's ops), and
  both stages whole;
- the stages in phase 18a's order (f32 then bf16), in others (bf16 only,
  bf16 then f32, one stage only, no grad-off forward), and as 18a made its
  inputs;
- each bf16 op after the f32 unpacked stage was captured, with leaf
  inputs and as 18a made them;
- the leads, on that failing case: the same capture twice (it held
  while ``graph_ms`` left ``torch.cuda.graph``'s capture stream current
  after a failed ``capture_end``, so the next input was made on it; it
  puts the caller's stream back now); the probe's own capture on a fresh
  stream; a warm-up
  on the capture stream (PyTorch's recipe); ``capture_error_mode``
  ``thread_local`` and ``relaxed``; ``.backward()`` in place of
  ``torch.autograd.grad``; ``torch.cuda.set_sync_debug_mode("error")``
  around the capture; the inputs made on the capture stream;
- no f32 capture at all: a bf16 op whose input is a non-leaf made on the
  eager stream, or on the capture stream;
- torch only, in a process that imports nothing of the port: ``F.conv2d``
  forward + backward, f32 then bf16 autocast (cast cache off), the inputs
  made as 18a made them or as leaf copies, and a non-leaf bf16 input alone.

``--only SUBSTRING`` (repeatable) runs the cases whose name holds one.

Prints one JSON line per case, ``{"case": ..., "captured": {capture:
true, false, or the error raised under the sync debug mode}}``, then one
JSON object of every case as its last line.
Needs a card and the port's kernels (built once, before the cases).
"""

from __future__ import annotations

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
F32 = ("f32", "unpacked", False, {})
F32_ALIAS = ("f32", "unpacked", False, {"inputs": "alias"})
ALIAS = {"inputs": "alias"}
# name -> steps: (dtype, stage or op, grad-off forward first, options). Options:
# "inputs": "copy" (the default), "alias" or "nonleaf" (see above); "stream":
# "capture" (inputs made on the capture stream); "warm": "capture" (warm-up on
# the capture stream); "mode": capture_error_mode; "backward": True
# (.backward()); "sync_debug": True. Any of these but inputs captures with
# ``capture`` below in place of ``graph_ms``.
CASES = {
    **{f"bf16 {op} alone": (("bf16", op, False, {}),) for op in OPS},
    "bf16 unpacked stage alone": (("bf16", "unpacked", False, {}),),
    "bf16 packed stage alone": (("bf16", "packed", False, {}),),
    "as 18a: f32 then bf16, packed then unpacked": (
        ("f32", "packed", True, {}), ("f32", "unpacked", True, {}),
        ("bf16", "packed", True, {}), ("bf16", "unpacked", True, {})),
    "as 18a, no grad-off forward": (
        ("f32", "packed", False, {}), ("f32", "unpacked", False, {}),
        ("bf16", "packed", False, {}), ("bf16", "unpacked", False, {})),
    "as 18a, inputs as 18a made them": (
        ("f32", "packed", True, ALIAS), ("f32", "unpacked", True, ALIAS),
        ("bf16", "packed", True, ALIAS), ("bf16", "unpacked", True, ALIAS)),
    "bf16 only": (("bf16", "packed", True, {}), ("bf16", "unpacked", True, {})),
    "bf16 then f32": (("bf16", "packed", True, {}), ("bf16", "unpacked", True, {}),
                      ("f32", "packed", True, {}), ("f32", "unpacked", True, {})),
    "unpacked only: f32 then bf16": (("f32", "unpacked", True, {}),
                                     ("bf16", "unpacked", True, {})),
    **{f"f32 unpacked stage, then bf16 {op}": (F32, ("bf16", op, False, {}))
       for op in ("upsample2x", "conv3x3_bias_relu", "head")},
    **{f"f32 unpacked stage, then bf16 {op}, inputs as 18a made them": (
        F32_ALIAS, ("bf16", op, False, ALIAS))
       for op in ("upsample2x", "conv3x3_bias_relu", "head")},
    # the leads, on the failing case (inputs as 18a made them)
    "aliased: bf16 upsample2x twice": (
        F32_ALIAS, ("bf16", "upsample2x", False, ALIAS), ("bf16", "upsample2x", False, ALIAS)),
    "aliased: bf16 upsample2x, own capture": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "mode": "global"})),
    "aliased: bf16 upsample2x, warm-up on the capture stream": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "warm": "capture"})),
    "aliased: bf16 upsample2x, thread_local": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "mode": "thread_local"})),
    "aliased: bf16 upsample2x, relaxed": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "mode": "relaxed"})),
    "aliased: bf16 upsample2x, backward()": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "backward": True})),
    "aliased: bf16 upsample2x, sync debug error": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "sync_debug": True})),
    "aliased: bf16 upsample2x, inputs made on the capture stream": (
        F32_ALIAS, ("bf16", "upsample2x", False, {**ALIAS, "stream": "capture"})),
    # no f32 capture: only the input's making
    "bf16 upsample2x alone, non-leaf input": (
        ("bf16", "upsample2x", False, {"inputs": "nonleaf"}),),
    "bf16 head alone, non-leaf input": (("bf16", "head", False, {"inputs": "nonleaf"}),),
    "bf16 upsample2x alone, non-leaf input made on the capture stream": (
        ("bf16", "upsample2x", False, {"inputs": "nonleaf", "stream": "capture"}),),
}
# torch only (no import of the port): name -> ((dtype, inputs), ...)
TORCH_CASES = {
    "torch only: bf16 conv2d alone": (("bf16", "copy"),),
    "torch only: f32 conv2d, then bf16 conv2d": (("f32", "copy"), ("bf16", "copy")),
    "torch only: f32 conv2d, then bf16 conv2d, inputs as 18a made them": (("f32", "alias"),
                                                                         ("bf16", "alias")),
    "torch only: bf16 conv2d alone, non-leaf input": (("bf16", "nonleaf"),),
}


def make_input(t: torch.Tensor, dtype, inputs: str) -> torch.Tensor:
    """A step's input from the shared ``t`` (see the module's docstring)."""
    if inputs == "copy":
        return t.detach().to(dtype, copy=True).requires_grad_(True)
    if inputs == "nonleaf":
        t.requires_grad_(True)
    return t.to(dtype).requires_grad_(True)


def capture(fn, stream=None, warm: str = "current", mode: str = "global",
            sync_debug: bool = False):
    """Warm ``fn`` up (3 calls), capture one call, replay it: True, False (invalidated), or the
    error the sync debug mode raised. Imports nothing of the port."""
    stream = stream or torch.cuda.Stream()
    if warm == "capture":
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(stream)
    else:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    current = torch.cuda.current_stream()
    graph = torch.cuda.CUDAGraph()
    try:
        if sync_debug:
            torch.cuda.set_sync_debug_mode("error")
        with torch.cuda.graph(graph, stream=stream, capture_error_mode=mode):
            fn()
        torch.cuda.set_sync_debug_mode(0)
        graph.replay()
        torch.cuda.synchronize()
        return True
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        if not sync_debug and "StreamCaptureInvalidated" not in str(e):
            raise
        torch.cuda.synchronize()
        return False if not sync_debug else str(e)[:300]
    finally:
        torch.cuda.set_stream(current)


def run_torch_case(name: str) -> dict:
    """A torch-only case: a 3x3 conv's forward + backward, f32 then bf16 (as listed)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(181)
    dev = torch.device("cuda")
    x0 = torch.randn(N, C, H, H, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(C, C, 3, 3, generator=gen) / (3 * C ** 0.5)).to(dev).requires_grad_(True)
    b = (0.1 * torch.randn(C, generator=gen)).to(dev).requires_grad_(True)
    gy = torch.randn(N, C, H, H, generator=gen).to(dev)
    captured = {}
    for dtype_name, inputs in TORCH_CASES[name]:
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x = make_input(x0, dtype, inputs)

        def fwd_bwd(x=x, dtype=dtype):
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16,
                                cache_enabled=False):
                y = F.relu(F.conv2d(x, w, b, padding=1))
            return torch.autograd.grad(y, [x, w, b], gy.to(dtype))

        captured[f"{dtype_name} conv2d forward + backward"] = capture(fwd_bwd)
    return captured


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

    def step(dtype_name: str, what: str, inputs: str):
        """(forward, its inputs, their output gradient) of a stage or an op."""
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x = make_input(x0, dtype, inputs)
        u = make_input(u0, dtype, inputs)
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

    def held(fn, opts: dict):
        if any(k in opts for k in ("warm", "mode", "stream", "backward", "sync_debug")):
            return capture(fn, stream, opts.get("warm", "current"), opts.get("mode", "global"),
                           opts.get("sync_debug", False))
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
    for k, (dtype_name, what, grad_off_first, opts) in enumerate(CASES[name]):
        stream = torch.cuda.Stream()
        if opts.get("stream") == "capture":
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                (f, inputs, g), amp = step(dtype_name, what, opts.get("inputs", "copy"))
            torch.cuda.current_stream().wait_stream(stream)
        else:
            (f, inputs, g), amp = step(dtype_name, what, opts.get("inputs", "copy"))
        seen = {(d, w) for d, w, *_ in CASES[name][:k]}
        tag = f"{dtype_name} {what}" + (f" ({k + 1})" if (dtype_name, what) in seen else "")

        def fwd(f=f, amp=amp):
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp, cache_enabled=False):
                return f()

        if grad_off_first:
            with torch.no_grad():
                captured[f"{tag} forward"] = held(fwd, opts)
        if opts.get("backward"):
            def fwd_bwd(fwd=fwd, g=g):
                fwd().backward(g)
        else:
            def fwd_bwd(fwd=fwd, inputs=inputs, g=g):
                return torch.autograd.grad(fwd(), inputs, g)
        captured[f"{tag} forward + backward"] = held(fwd_bwd, opts)
    return captured


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--case":  # one case, in its own process
        name = sys.argv[2]
        run = run_torch_case if name in TORCH_CASES else run_case
        print(json.dumps({"case": name, "captured": run(name)}), flush=True)
        return 0
    only = [v for k, v in zip(sys.argv[1:], sys.argv[2:]) if k == "--only"] or [""]
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from unet_embroidery_seg_torch.ops import _build

    _build.build(["upsample2x", "upsample2x_bwd", "conv3x3_same"])
    results = {}
    for name in (n for n in (*CASES, *TORCH_CASES) if any(o in n for o in only)):
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
