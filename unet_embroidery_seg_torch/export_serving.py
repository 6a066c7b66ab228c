"""Serving artifacts by ``torch.export`` (port of ``scripts/export_serving.py``).

``python -m unet_embroidery_seg_torch.export_serving --weights run/train/exp/weights/best.pth
[--model unet_resnet50] [--num-classes 1] [--input-size 480] [--batches 1 8]
[--platforms cuda cpu] [--out serving/] [--check]``

The inference forward with the softmax, what ``predict_probs`` computes
over ``engine/steps.py:make_predict_fn`` (NHWC float32 images in, NHWC
float32 probabilities out; ``--amp``, the default, under bf16 autocast), is
exported with ``torch.export`` under ``torch.no_grad()`` and saved with
``torch.export.save``, one file per batch size and platform:
``{out}/{model}_{size}_b{B}_{platform}.pt2``, plus ``manifest.json``.
``--platforms`` takes ``cuda`` and/or ``cpu``: a ``cuda`` artifact is
exported from a model on the card and holds the card's tensors, a ``cpu``
one from a model on the CPU. Weights are baked into the program by default
(one self-contained file per deployable model); ``--no-bake-weights``
exports ``f(state_dict, x)`` instead, through ``torch.func.functional_call``,
and serving passes the ``.pth`` ``state_dict`` at call time.

The exported graph holds the hand-written kernels as operator nodes
(``unet_seg::upsample2x``, ``unet_seg::conv3x3_bias_relu``, ...;
``ops/library.py``), so a ``cuda`` artifact runs them on the card. That is
the one difference from the JAX package's StableHLO artifact, which needs
only ``jax``: this one needs ``torch`` plus the registration of the port's
operators, which ``load_artifact`` does (it imports the two kernel
modules) before ``torch.export.load``. Call the loaded module under
``torch.no_grad()``.

``--check`` loads each artifact back, runs it on random data beside the
direct forward and records ``check_max_abs_diff``; above 1e-3 it fails.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import os
import warnings

import numpy as np
import torch
import torch.nn as nn

from unet_embroidery_seg_torch.engine import checkpoint
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.models.unet_multitask import MultiTaskUNet
from unet_embroidery_seg_torch.ops.library import registered_ops
from unet_embroidery_seg_torch.utils.device import resolve_device, set_float32_precision

CHECK_TOLERANCE = 1e-3


class Predict(nn.Module):
    """NHWC float32 images -> NHWC float32 softmax probabilities, the model in eval mode.

    NHWC permuted to NCHW is the model's ``channels_last`` layout, which the
    kernels read; ``amp`` runs the model under bf16 autocast.
    """

    def __init__(self, model: nn.Module, amp: bool):
        super().__init__()
        self.model = model.eval()
        self.amp = amp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=self.amp):
            logits = self.model(x)
        return torch.softmax(logits.permute(0, 2, 3, 1), dim=-1)


class _Unbaked(nn.Module):
    """``f(state_dict, x)``: ``predict`` with the model's parameters and buffers passed in."""

    def __init__(self, predict: Predict):
        super().__init__()
        self.predict = predict

    def forward(self, state: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self.predict, {f"model.{k}": v for k, v in state.items()}, (x,))


def build_predict(model: nn.Module, amp: bool) -> Predict:
    """The serving forward of a single-head model (multitask_unet's pair has no softmax here)."""
    if isinstance(model, MultiTaskUNet):
        raise ValueError("export_serving: the artifact holds a single-head model's "
                         "segmentation forward; multitask_unet returns two heads")
    return Predict(model, amp)


def _drop_metadata_asserts(exported: torch.export.ExportedProgram) -> int:
    """Erase the ``aten._assert_tensor_metadata`` nodes; returns how many.

    Export puts one before each dtype cast it records, 213 per bf16
    unet_resnet50 forward (the autocast region's casts). Each is a host
    dispatch at every call: on an H100 they made the artifact's forward at
    480^2, batch 1, 1.4x eager's (``chip_smoke.py`` phase 13b). They check
    what the program was traced with; the program checks its input's shape
    and dtype at its entry.
    """
    erased = 0
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in list(gm.graph.nodes):
                if node.target is torch.ops.aten._assert_tensor_metadata.default:
                    gm.graph.erase_node(node)
                    erased += 1
            gm.recompile()
    return erased


def export_one(predict: Predict, batch: int, size: int, bake: bool = True) -> bytes:
    """The bytes of ``torch.export.save`` of ``predict`` at (batch, size, size, 3) float32.

    The platform is the model's device. ``bake=False`` exports ``f(state_dict, x)``.
    """
    x = torch.zeros(batch, size, size, 3, device=next(predict.parameters()).device)
    if bake:
        program, args = predict, (x,)
    else:
        # The traced module's own parameters are never read (the call's
        # state dict stands in for them): on the meta device they add no
        # bytes to the artifact.
        shell = Predict(copy.deepcopy(predict.model).to("meta"), predict.amp)
        program, args = _Unbaked(shell), (predict.model.state_dict(), x)
    buf = io.BytesIO()
    with torch.no_grad():
        exported = torch.export.export(program, args)
    exported.example_inputs = None  # else saved with it: the input, or the whole state dict
    _drop_metadata_asserts(exported)
    with warnings.catch_warnings():
        # The model's 4-D weights are channels_last, which the archive calls
        # "not complete" (not contiguous) and stores with their strides, as
        # they are: a dense tensor loses nothing (--check loads it back).
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(exported, buf)
    return buf.getvalue()


def load_artifact(path_or_bytes: str | bytes) -> nn.Module:
    """The serving module of an artifact: the port's operators registered, then loaded.

    Baked: ``module(x)``; ``--no-bake-weights``: ``module(state_dict, x)``.
    """
    registered_ops()
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    return torch.export.load(src).module()


def check_artifact(data: bytes, predict: Predict, batch: int, size: int, bake: bool) -> float:
    """Max |artifact - direct forward| over random NHWC data in [0, 1) (seed 0)."""
    device = next(predict.parameters()).device
    x = torch.from_numpy(np.random.RandomState(0).rand(batch, size, size, 3)
                         .astype(np.float32)).to(device)
    module = load_artifact(data)
    with torch.no_grad():
        got = module(x) if bake else module(predict.model.state_dict(), x)
        want = predict(x)
    return float((got - want).abs().max())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True, help="A model-only .pth (the train CLI's best.pth)")
    p.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS))
    p.add_argument("--num-classes", default=1, type=int,
                   help="Foreground classes (predict.py convention: total = N+1)")
    p.add_argument("--decoder-width", default=1.0, type=float)
    p.add_argument("--input-size", default=480, type=int)
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    p.add_argument("--platforms", nargs="+", default=["cuda", "cpu"], choices=["cuda", "cpu"])
    p.add_argument("--amp", default=True, action=argparse.BooleanOptionalAction,
                   help="bf16 compute inside the artifact (params stay f32)")
    p.add_argument("--bake-weights", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--out", default="serving")
    p.add_argument("--check", action="store_true",
                   help="Load each artifact back and compare it with the direct forward on "
                        "random data, on the artifact's platform")
    args = p.parse_args(argv)
    set_float32_precision()

    os.makedirs(args.out, exist_ok=True)
    manifest = {
        "model": args.model,
        "num_classes_total": args.num_classes + 1,
        "decoder_width": args.decoder_width,
        "input_size": args.input_size,
        "platforms": args.platforms,
        "amp": args.amp,
        "baked_weights": args.bake_weights,
        "weights": os.path.abspath(args.weights),
        "torch_version": torch.__version__,
        "output": "softmax probabilities (N, H, W, C), NHWC float",
        "artifacts": {str(b): {} for b in args.batches},
    }
    for platform in args.platforms:
        model = build_model(args.model, args.num_classes + 1, decoder_width=args.decoder_width,
                            device=resolve_device(platform))
        predict = build_predict(checkpoint.load_weights(args.weights, model), args.amp)
        for b in args.batches:
            data = export_one(predict, b, args.input_size, args.bake_weights)
            name = f"{args.model}_{args.input_size}_b{b}_{platform}.pt2"
            with open(os.path.join(args.out, name), "wb") as f:
                f.write(data)
            entry = {"file": name, "bytes": len(data)}
            manifest["artifacts"][str(b)][platform] = entry
            print(f"[export] {name}: {len(data) / 1e6:.1f} MB", flush=True)
            if args.check:
                diff = check_artifact(data, predict, b, args.input_size, args.bake_weights)
                entry["check_max_abs_diff"] = diff
                print(f"[check] b{b} {platform}: max|Δ| = {diff:.2e}", flush=True)
                if not diff < CHECK_TOLERANCE:
                    raise SystemExit(f"export_serving: {name} differs from the direct "
                                     f"forward by {diff:.3e} (limit {CHECK_TOLERANCE})")

    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"[export] manifest -> {os.path.join(args.out, 'manifest.json')}")
    return manifest


if __name__ == "__main__":
    main()
