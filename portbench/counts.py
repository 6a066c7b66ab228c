"""Operations, bytes and least times: the benchmark's own arithmetic.

The roofline rule is ``chip_smoke.bound``'s: the least time of a piece of
work is the larger of its operations over the peak rate and its bytes over
the memory's rate, each input byte read once and each output byte written
once. Peaks come from ``device/<card>.json``.

- ``model_flops``: operations of one image's forward, counted from the
  reference model's layer shapes (every conv and linear, 2 per
  multiply-add), traced on the ``meta`` device, so nothing is computed.
  A train step is 3 forwards (forward, input gradient, weight gradient),
  nothing recomputed.
- ``conv3x3_work`` / ``upsample_work``: the configuration's site list
  (``square_conv_sites``, ``upsample_sites``) at a cell's size and batch.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import torch
import torch.nn as nn

DEVICE_DIR = Path(__file__).resolve().parent / "device"
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


@lru_cache(maxsize=None)
def peaks(card: str = "h100") -> dict:
    return json.loads((DEVICE_DIR / f"{card}.json").read_text())


def peak_flops(dtype: str, card: str = "h100") -> float:
    """The dense peak a cell's arithmetic is held to: bf16, or TF32 for float32 cells (the
    program runs cuDNN's float32 convs in TF32)."""
    return peaks(card)["peak_flops"][{"bf16": "bf16", "f32": "tf32"}[dtype]]


def least_s(flops: float, nbytes: float, dtype: str, card: str = "h100") -> float:
    p = peaks(card)
    return max(flops / peak_flops(dtype, card), nbytes / p["hbm_bytes_per_s"])


def model_flops(model: nn.Module, size: int) -> float:
    """Forward operations of one ``size``^2 image through ``model`` (convs and linears)."""
    total = [0.0]

    def hook(m, inputs, out):
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * kh * kw
        else:
            total[0] += 2.0 * out.numel() * m.in_features

    meta = model.to("meta")
    handles = [m.register_forward_hook(hook) for m in meta.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            meta(torch.empty((1, 3, size, size), device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def conv3x3_work(sites: list[dict], size: int, batch: int, dtype: str,
                 dgrad: bool) -> tuple[float, float]:
    """(operations, least seconds) of the square 3x3 convs: forward, and input gradient too."""
    e = ELEMENT_BYTES[dtype]
    flops = least = 0.0
    for s in sites:
        c, hw = s["channels"], (size // s["stride"]) ** 2
        act = batch * c * hw
        f = 2.0 * act * c * 9
        passes = [2 * act + 9 * c * c + (c if s["bias"] else 0)]
        if dgrad:
            passes.append(2 * act + 9 * c * c)
        for nbytes in passes:
            flops += f
            least += least_s(f, nbytes * e, dtype)
    return flops, least


def upsample_work(sites: list[dict], size: int, batch: int, dtype: str,
                  backward: bool) -> float:
    """Least seconds of the 2x upsamples (bound by bytes: input once, output once)."""
    e = ELEMENT_BYTES[dtype]
    least = 0.0
    for s in sites:
        small = batch * s["channels"] * (size // s["stride_in"]) ** 2
        least += (1 + backward) * least_s(0.0, 5 * small * e, dtype)
    return least
