"""The ResNet stem's three lowerings (``torch_alternates.StemConv7x7``) against JAX's and ``direct``.

On numpy inputs from a seed, f32 on the CPU: each mode's output and weight
gradient against JAX's ``StemConv7x7(mode)`` on the same kernel and against
the port's ``direct`` mode; odd sizes fall back to the direct conv;
``ResNet50Backbone`` with each stem (one block per stage) against JAX's; the
state dict is the same in every mode; and over the space axis (bands as
threads of this process, ``tests/test_torch_space.py``'s ``ThreadSpace``)
each mode's bands equal the whole image's on a 1x2 and a 2x2 mesh.
Tolerance: f32 sums of 147 products in another order, 1e-5 of the
reference's largest value (``test_torch_space.TOL``); the backbone, 17
layers deep, 1e-4.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_alternates as alt
from test_torch_space import _check_split, _close, band, on_shards, split_module_case
from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_tpu.models.resnet_backbone import ResNet50Backbone as JaxBackbone
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.models.factory import load_weights_flexible
from unet_embroidery_seg_torch.models.resnet_backbone import ResNet50Backbone
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

MODES = alt.STEM_MODES
FEATURES = 16
LAYERS = (1, 1, 1, 1)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_stem(mode: str, x: np.ndarray, seed: int = 0):
    """(JAX's StemConv7x7(mode) output, its kernel) on ``x`` (NHWC)."""
    stem = jax_blocks.StemConv7x7(FEATURES, mode=mode)
    variables = stem.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return np.asarray(stem.apply(variables, jnp.asarray(x))), variables


def _port_stem(mode: str, kernel: np.ndarray) -> alt.StemConv7x7:
    stem = alt.StemConv7x7(FEATURES, mode=mode)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(np.array(kernel).transpose(3, 2, 0, 1)))
    return stem


@pytest.mark.parametrize("mode", MODES)
def test_stem_equals_jax_and_direct(mode):
    x = np.random.RandomState(1).randn(2, 32, 24, 3).astype(np.float32)
    want, variables = _jax_stem(mode, x)
    kernel = variables["params"]["kernel"]
    got = _port_stem(mode, kernel)(_nchw(x))
    assert got.shape == (2, FEATURES, 16, 12)
    _close(torch.from_numpy(_nhwc(got)), torch.from_numpy(want), f"{mode} vs JAX")
    direct = _port_stem("direct", kernel)(_nchw(x))
    _close(got.detach(), direct.detach(), f"{mode} vs direct")


@pytest.mark.parametrize("mode", ["packed", "im2col"])
@pytest.mark.parametrize("shape", [(1, 33, 32, 3), (1, 32, 31, 3)])
def test_odd_sizes_fall_back_to_the_direct_conv(mode, shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want, variables = _jax_stem(mode, x)
    stem = _port_stem(mode, variables["params"]["kernel"])
    got = stem(_nchw(x))
    direct = torch.nn.functional.conv2d(_nchw(x), stem.weight, stride=2, padding=3)
    torch.testing.assert_close(got, direct, rtol=0, atol=0)
    _close(torch.from_numpy(_nhwc(got)), torch.from_numpy(want), f"{mode} vs JAX")


@pytest.mark.parametrize("mode", MODES)
def test_weight_gradient_equals_jax_and_direct(mode):
    """One SGD step's gradient of the stem weight, through each rearrangement."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    gy = rs.randn(2, 8, 8, FEATURES).astype(np.float32)
    _, variables = _jax_stem(mode, x)
    stem = jax_blocks.StemConv7x7(FEATURES, mode=mode)
    grad = jax.grad(lambda v: jnp.sum(stem.apply(v, jnp.asarray(x)) * gy))(variables)
    want = np.asarray(grad["params"]["kernel"]).transpose(3, 2, 0, 1)
    grads = {}
    for m in (mode, "direct"):
        port = _port_stem(m, variables["params"]["kernel"])
        (port(_nchw(x)) * _nchw(gy)).sum().backward()
        grads[m] = port.weight.grad
    _close(grads[mode], torch.from_numpy(want), f"{mode} dW vs JAX")
    _close(grads[mode], grads["direct"], f"{mode} dW vs direct")


def _backbone_state(variables: dict) -> dict:
    """A JAX backbone's variables as the port's backbone state dict (the model's map, unprefixed)."""
    wrapped = {c: {"resnet": variables[c]} for c in ("params", "batch_stats")}
    state = state_dict_from_jax("unet_resnet50", wrapped)
    return {k[len("resnet."):]: v for k, v in state.items()}


@pytest.mark.parametrize("mode", MODES)
def test_backbone_features_equal_jax(mode):
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    jmodel = JaxBackbone(layers=LAYERS, stem_mode=mode)
    variables = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x), train=False)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = alt.set_stem_mode(ResNet50Backbone(layers=LAYERS), mode).eval()
    model.load_state_dict(_backbone_state(variables), strict=True)
    with torch.no_grad():
        got = model(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"feat{i + 1}")


def test_the_state_dict_is_the_same_in_every_mode(tmp_path):
    states = {m: alt.set_stem_mode(ResNet50Backbone(layers=LAYERS), m).state_dict() for m in MODES}
    for m in MODES:
        assert {k: v.shape for k, v in states[m].items()} == \
            {k: v.shape for k, v in states["direct"].items()}
    assert states["packed"]["conv1.weight"].shape == (64, 3, 7, 7)
    # a model switched to another mode loads a direct model's checkpoint, strictly and flexibly
    direct = build_model("unet_resnet50", 2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    path = tmp_path / "best.pth"
    torch.save(direct.state_dict(), path)
    try:
        state = torch.load(path, weights_only=True)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    for m in ("packed", "im2col"):
        model = build_model("unet_resnet50", 2, device="cpu")
        alt.set_stem_mode(model.resnet, m)
        assert "resnet.conv1.weight" in state
        model.load_state_dict(state, strict=True)
        assert load_weights_flexible(model, state) == (len(state), 0)
        torch.testing.assert_close(model.resnet.conv1.weight, direct.resnet.conv1.weight,
                                   rtol=0, atol=0)


def test_an_unknown_mode_raises():
    with pytest.raises(ValueError, match="stem mode"):
        alt.StemConv7x7(8, mode="winograd")


def _stem(mode: str) -> alt.StemConv7x7:
    g = torch.Generator().manual_seed(6)
    stem = alt.StemConv7x7(8, mode=mode)
    with torch.no_grad():
        stem.weight.copy_(torch.randn(stem.weight.shape, generator=g) / 12)
    return stem.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_space_bands_equal_one_process(mode, mesh):
    """Each rank's band of every image (both halves of the batch on 2x2) against the whole image:
    output and input gradient by rows, the weight gradient summed, within TOL."""
    x = torch.randn(4, 3, 32, 24, generator=torch.Generator().manual_seed(7))
    halves = [x] if mesh == "1x2" else [x[:2], x[2:]]  # 2x2: the data axis's rows, each split
    for rows in halves:
        _check_split(*split_module_case(_stem(mode), (rows,), 2))


def test_packed_band_takes_four_rows_above():
    """The packed mode's halo starts on an even row: 4 rows above the band, 2 below."""
    seen = []
    x = torch.randn(1, 3, 16, 8, generator=torch.Generator().manual_seed(8))

    def shard(space):
        exchange = space.exchange

        def spy(t, top, bottom, zero_edges=False):
            seen.append((space.index, top, bottom, zero_edges))
            return exchange(t, top, bottom, zero_edges)

        space.exchange = spy
        stem = _stem("packed")
        blocks.set_space_axis(_Host(stem), space)
        return stem(x[:, :, band(16, space.index, 2)])

    parts = on_shards(shard, 2)
    assert sorted(seen) == [(0, 4, 2, True), (1, 4, 2, True)]
    whole = _stem("packed")(x)
    _close(torch.cat(parts, 2), whole, "packed bands")


class _Host(torch.nn.Module):
    takes_space_axis = True

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
