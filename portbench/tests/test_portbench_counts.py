"""The benchmark's operation and byte counts against independent counts of the reference models."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness
from portbench.reference import models as ref_models

CONFIGS = ("unet_resnet50", "unet_plain")
# Forward operations of one 512^2 image, counted with hooks on convs and linears.
PUBLISHED_GFLOP = {"unet_resnet50": (182.9, 58.0), "unet_plain": (445.5, 173.9)}


def _config(name: str) -> dict:
    return harness.load_json(harness.PKG / "configs" / f"{name}.json")


def _meta(config: dict, diff: bool = False) -> nn.Module:
    with torch.device("meta"):
        return ref_models.build(config, diff)


def _port_sites(config: dict) -> set[str]:
    """The modules of the program's model that run its hand-written kernels."""
    from unet_embroidery_seg_torch.models import blocks
    from unet_embroidery_seg_torch.models.factory import _FAMILIES, UNetResNet50

    with torch.device("meta"):
        model = (UNetResNet50(2) if config["model"] == "unet_resnet50"
                 else _FAMILIES[config["model"]](num_classes=2))
    kinds = (blocks.SquareConv3x3, blocks.Conv3x3Same, blocks.Upsample2x)
    return {name for name, m in model.named_modules() if isinstance(m, kinds)}


def _site_shapes(config: dict, size: int, batch: int):
    """{module: (x numel, y numel, weight numel, bias numel)} of the reference model's modules
    at the program's kernel sites, from hooks on a meta forward."""
    model = _meta(config)
    sites = _port_sites(config)
    seen, handles = {}, []
    for name, m in model.named_modules():
        if name in sites:
            def hook(mod, inp, out, name=name):
                w = getattr(mod, "weight", None)
                b = getattr(mod, "bias", None)
                seen[name] = (inp[0].numel(), out.numel(), 0 if w is None else w.numel(),
                              0 if b is None else b.numel())
            handles.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model(torch.empty((batch, 3, size, size), device="meta"))
    for h in handles:
        h.remove()
    return seen


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_match_torch_flop_counter(name):
    config = _config(name)
    with FlopCounterMode(display=False) as fc, torch.device("meta"):
        _meta(config)(torch.empty((1, 3, 512, 512)))
    ours = counts.model_flops(_meta(config), 512)
    assert ours == fc.get_total_flops()
    assert ours / 1e9 == pytest.approx(PUBLISHED_GFLOP[name][0], abs=0.05)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size,batch", [(512, 8), (480, 32)])
def test_site_lists_are_the_models_square_convs_and_upsamples(name, size, batch):
    config = _config(name)
    seen = _site_shapes(config, size, batch)
    convs = {s["module"]: s for s in config["square_conv_sites"]}
    ups = {s["module"]: s for s in config["upsample_sites"]}
    assert set(seen) == set(convs) | set(ups) == _port_sites(config)
    for module, s in convs.items():
        x, y, w, b = seen[module]
        act = batch * s["channels"] * (size // s["stride"]) ** 2
        assert (x, y, w, b) == (act, act, 9 * s["channels"] ** 2, s["channels"] if s["bias"] else 0)
    for module, s in ups.items():
        small = batch * s["channels"] * (size // s["stride_in"]) ** 2
        assert seen[module][:2] == (small, 4 * small)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_conv_and_upsample_work_from_hooks(name, dtype):
    config, size, batch = _config(name), 512, 8
    seen = _site_shapes(config, size, batch)
    e, p = counts.ELEMENT_BYTES[dtype], counts.peaks()
    peak = counts.peak_flops(dtype)
    flops = least = 0.0
    for s in config["square_conv_sites"]:
        x, y, w, b = seen[s["module"]]
        f = 2.0 * y * 9 * s["channels"]
        flops += 2 * f
        least += max(f / peak, (x + y + w + b) * e / p["hbm_bytes_per_s"])
        least += max(f / peak, (x + y + w) * e / p["hbm_bytes_per_s"])  # dgrad: dy, w -> dx
    ours = counts.conv3x3_work(config["square_conv_sites"], size, batch, dtype, dgrad=True)
    assert ours[0] == pytest.approx(flops, rel=1e-12) and ours[1] == pytest.approx(least, rel=1e-12)
    assert ours[0] / 2 / batch / 1e9 == pytest.approx(PUBLISHED_GFLOP[name][1], abs=0.05)
    up = sum((x + y) * e for m, (x, y, _, _) in seen.items()
             if m in {s["module"] for s in config["upsample_sites"]})
    assert counts.upsample_work(config["upsample_sites"], size, batch, dtype, backward=True) == \
        pytest.approx(2 * up / p["hbm_bytes_per_s"], rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert counts.peak_flops("bf16") == 989e12 and counts.peak_flops("f32") == 495e12
    assert counts.peaks()["hbm_bytes_per_s"] == 3.35e12
