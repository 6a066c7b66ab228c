"""The hand-written kernels as registered operators (``unet_seg::*``), on the CPU.

``torch.library.opcheck`` holds each operator's schema, its fake
implementation (shape, dtype and strides) against the CPU implementation
(the plain version), and its behaviour under AOT dispatch with dynamic
shapes. Then each model family, exported with ``torch.export`` in eval mode
under bf16 autocast, must hold the operators as graph nodes at the counts
the model has: the kernels reach an exported program.
"""

import collections

import numpy as np
import pytest
import torch

from unet_embroidery_seg_torch.models import build_model
from unet_embroidery_seg_torch.models.blocks import init_weights
from unet_embroidery_seg_torch.models.unet_attention import AttentionUNet
from unet_embroidery_seg_torch.models.unet_dualdense import DualDenseUNet
from unet_embroidery_seg_torch.models.unet_plain import UNetPlain
from unet_embroidery_seg_torch.ops.conv3x3 import pack_conv3x3_grad
from unet_embroidery_seg_torch.ops.library import NAMESPACE, registered_ops

OPS = registered_ops()
C, H = 8, 6  # channels, input rows and columns of the cases


def _x(seed: int, shape, dtype) -> torch.Tensor:
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


def _cases(dtype):
    x = _x(0, (2, C, H, H), dtype)
    w = _x(1, (C, C, 3, 3), torch.float32).contiguous()
    b = _x(2, (C,), torch.float32)
    g_up = _x(3, (2, C, 2 * H, 2 * H), dtype)
    packed = pack_conv3x3_grad(w, dtype)  # grad on: the forward packs, dgrad reads it
    return {
        "upsample2x": [(x, True), (x, False)],
        "upsample2x_backward": [(g_up, True), (g_up, False)],
        "conv3x3_bias_relu": [(x, w, b, True), (x, w, b, False), (x, w, b, False, 1, 1, packed)],
        "conv3x3_same": [(x, w, True), (x, w, False), (x, w, False, 1, 1, packed)],
        "conv3x3_dgrad": [(x, w, packed), (x, w, packed, 2, 0)],
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name, dtype):
    for args in _cases(dtype)[name]:
        torch.library.opcheck(OPS[name], args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_opcheck_upsample_backward_on_a_cat_gradient_slice(dtype):
    # The decoder's gradient reaches the upsample as a channel slice of the
    # torch.cat gradient: channels_last-like, not contiguous. The operator
    # takes it as it is (the kernel reads it in place).
    g = _x(4, (2, 3 * C, 2 * H, 2 * H), dtype)[:, C:]
    assert not g.is_contiguous() and not g.is_contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(OPS["upsample2x_backward"], (g, True))


def test_cpu_result_has_the_fake_strides_where_a_dimension_is_one():
    # One channel: ``contiguous(channels_last)`` would keep NCHW strides.
    x = _x(5, (2, 1, H, H), torch.float32)
    torch.library.opcheck(OPS["upsample2x"], (x, False))
    assert OPS["upsample2x"](x, False).stride() == torch.empty(
        2, 1, 2 * H, 2 * H, memory_format=torch.channels_last).stride()


def _family(name: str) -> torch.nn.Module:
    """The family at the narrow widths of the family tests; unet_resnet50 and multitask_unet full."""
    small = {"unet_plain": lambda: UNetPlain(2, 8), "attention_unet": lambda: AttentionUNet(2, 8),
             "dualdense_unet": lambda: DualDenseUNet(2, 8, growth_rate=8)}
    if name not in small:
        return build_model(name, 2, device="cpu").eval()
    model = init_weights(small[name](), torch.Generator().manual_seed(0))
    return model.to(memory_format=torch.channels_last).eval()


class _Bf16(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return self.model(x)


def _op_nodes(gm: torch.fx.GraphModule, recurse: bool) -> list:
    graphs = [m for m in gm.modules() if isinstance(m, torch.fx.GraphModule)] if recurse else [gm]
    return [n for g in graphs for n in g.graph.nodes
            if n.op == "call_function" and getattr(n.target, "namespace", None) == NAMESPACE]


@pytest.mark.parametrize("name,want", [
    ("unet_resnet50", {"upsample2x": 5, "conv3x3_bias_relu": 6}),
    ("multitask_unet", {"upsample2x": 5, "conv3x3_bias_relu": 6}),
    ("unet_plain", {"upsample2x": 4, "conv3x3_same": 9}),
    ("attention_unet", {"upsample2x": 4, "conv3x3_same": 9}),
    ("dualdense_unet", {"upsample2x": 4}),
])
def test_exported_graph_holds_the_kernels(name, want):
    x = _x(6, (1, 3, 32, 32), torch.float32)
    model = _Bf16(_family(name))
    with torch.no_grad():
        ep = torch.export.export(model, (x,))
    # The autocast region is a submodule (wrap_with_autocast): walk them all.
    nodes = _op_nodes(ep.graph_module, recurse=True)
    assert collections.Counter(n.target._opname for n in nodes) == want
    # Exported with grad off, every conv node bakes the packed-weight cache on.
    assert all(n.args[-1] is True for n in nodes if "conv3x3" in n.target.name())
    # The exported program computes what the model computes.
    with torch.no_grad():
        got, ref = ep.module()(x), model(x)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, ref))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decomposition_lifts_the_kernels_to_the_top_level_graph():
    x = _x(7, (1, 3, 32, 32), torch.float32)
    with torch.no_grad():
        ep = torch.export.export(_Bf16(_family("unet_plain")), (x,))
    assert not _op_nodes(ep.graph_module, recurse=False)  # inside the autocast submodule
    lifted = _op_nodes(ep.run_decompositions().graph_module, recurse=False)
    assert collections.Counter(n.target._opname for n in lifted) == {"upsample2x": 4,
                                                                     "conv3x3_same": 9}
