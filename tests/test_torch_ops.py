"""The port's ops against the JAX package on the CPU: resize tables, upsample, conv3x3.

Inputs are made by numpy from a seed and handed to both sides. The Pallas
TPU kernels (docs/negative-results/) are loaded by path and run in
interpret mode, as they run on a CPU; nothing in the JAX package changes.
On the CPU the port's wrappers take their plain versions, which these tests
hold against JAX; the CUDA kernels are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_torch.models.resnet_backbone import ResNet50Backbone
from unet_embroidery_seg_torch.ops import _build, resize
from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_bias_relu_plain
from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

NEG = Path(__file__).resolve().parent.parent / "docs" / "negative-results"


def _load_negative_result(name: str):
    spec = importlib.util.spec_from_file_location(f"_neg_{name}", NEG / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(x_nhwc.copy()).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# --- resize tables and upsample ------------------------------------------------


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_size", [1, 3, 15, 30, 60, 120, 240])
def test_linear_coords_equal_jax_bit_for_bit(in_size, align_corners):
    # The CUDA kernel reads these tables, so its weights are the JAX ones exactly.
    ours = resize._linear_coords(in_size, 2 * in_size, align_corners)
    theirs = jax_resize._linear_coords(in_size, 2 * in_size, align_corners)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        resize._interp_matrix(in_size, 2 * in_size, align_corners),
        jax_resize._interp_matrix(in_size, 2 * in_size, align_corners),
    )


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape", [(2, 15, 15, 5), (1, 3, 7, 4), (2, 8, 6, 16), (1, 1, 2, 3)])
def test_upsample_plain_matches_jax_resize(shape, align_corners):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jax_resize.upsample2x(jnp.asarray(x), align_corners=align_corners))
    got = upsample2x_plain(_nchw(x), align_corners)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # f32 both sides; each output is a <=4-term convex combination of O(1)
    # inputs, so only f32 rounding of the sums differs.
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample_plain_matches_pallas_kernel(align_corners):
    pallas = _load_negative_result("pallas_upsample")
    x = np.random.RandomState(7).randn(2, 16, 8, 128).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas.upsample2x_pallas(jnp.asarray(x), align_corners))
    got = _nhwc(upsample2x_plain(_nchw(x), align_corners))
    # f32 both sides, same taps and weights; only the order of the f32 lerps
    # differs (shifted adds vs matrix contractions).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_upsample_wrapper_takes_plain_version_on_cpu():
    x = _nchw(np.random.RandomState(3).randn(2, 5, 7, 6).astype(np.float32))
    before = upsample2x.launches
    out = upsample2x(x, align_corners=True)
    assert upsample2x.launches == before  # no kernel launched on the CPU
    torch.testing.assert_close(out, upsample2x_plain(x, True), rtol=0, atol=0)
    assert out.shape == (2, 6, 10, 14)


def test_stem_max_pool_matches_jax():
    # The backbone's stock nn.MaxPool2d(3, 2, 0, ceil_mode=True) stands in for
    # the JAX max_pool: odd sizes exercise the ceil-mode trailing window.
    x = np.random.RandomState(4).randn(2, 15, 17, 3).astype(np.float32)
    want = np.asarray(jax_resize.max_pool(jnp.asarray(x), 3, 2, padding=0, ceil_mode=True))
    with torch.no_grad():
        got = _nhwc(ResNet50Backbone().maxpool(_nchw(x)))
    np.testing.assert_array_equal(got, want)  # a max is exact


# --- conv3x3 ---------------------------------------------------------------------


def _conv_inputs(n, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    return x, w_hwio, b


def _full_conv_from_relu_halves(x_nhwc, w_hwio, b):
    """conv + bias recovered from the fused ReLU: relu(y) - relu(-y) = y."""
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    bias = torch.from_numpy(b)
    x = _nchw(x_nhwc)
    pos = conv3x3_bias_relu_plain(x, w_oihw, bias)
    neg = conv3x3_bias_relu_plain(x, -w_oihw, -bias)
    return pos, _nhwc(pos - neg)


@pytest.mark.parametrize("shape", [(2, 9, 11, 8), (1, 16, 16, 5)])
def test_conv3x3_plain_matches_flax_conv3x3(shape):
    n, h, w, c = shape
    x, w_hwio, b = _conv_inputs(n, h, w, c, seed=h * w + c)
    conv = jax_blocks.conv3x3(c, use_bias=True)
    want = np.asarray(
        conv.apply({"params": {"kernel": jnp.asarray(w_hwio), "bias": jnp.asarray(b)}},
                   jnp.asarray(x))
    )
    pos, got = _full_conv_from_relu_halves(x, w_hwio, b)
    # f32 both sides with matmul precision "highest" in JAX; fan-in 9*C <= 72
    # terms of O(1) products, so f32 summation order gives < 1e-5.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(pos), np.maximum(want, 0.0), rtol=0, atol=1e-5)


def test_conv3x3_plain_matches_pallas_kernel():
    pallas = _load_negative_result("pallas_conv")
    x, w_hwio, _ = _conv_inputs(2, 32, 8, 16, seed=11)
    b = np.zeros(16, np.float32)  # the Pallas kernel leaves the bias to its caller
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas.conv3x3_same(jnp.asarray(x), jnp.asarray(w_hwio)))
    _, got = _full_conv_from_relu_halves(x, w_hwio, b)
    # f32 both sides; per-row im2col GEMMs (K = 3*16) vs nine K = 16 products.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_conv3x3_wrapper_takes_plain_version_on_cpu():
    x, w_hwio, b = _conv_inputs(1, 6, 5, 4, seed=5)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    before = conv3x3_bias_relu.launches
    out = conv3x3_bias_relu(_nchw(x), w_oihw, torch.from_numpy(b))
    assert conv3x3_bias_relu.launches == before
    want = conv3x3_bias_relu_plain(_nchw(x), w_oihw, torch.from_numpy(b))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize(
    "w_shape,b_shape", [((4, 3, 3, 3), (4,)), ((4, 4, 1, 1), (4,)), ((4, 4, 3, 3), (3,))]
)
def test_conv3x3_rejects_non_square_weights(w_shape, b_shape):
    x = torch.zeros(1, 4, 5, 5)
    with pytest.raises(ValueError):
        conv3x3_bias_relu(x, torch.zeros(w_shape), torch.zeros(b_shape))


@pytest.mark.parametrize("fn", ["upsample", "conv"])
def test_wrappers_raise_off_cpu_and_cuda(fn):
    # The meta device is neither: no plain fallback, no kernel, an error.
    x = torch.empty(1, 4, 5, 5, device="meta")
    with pytest.raises(ValueError):
        if fn == "upsample":
            upsample2x(x, True)
        else:
            conv3x3_bias_relu(x, torch.empty(4, 4, 3, 3, device="meta"),
                              torch.empty(4, device="meta"))


def test_nvcc_command_targets_hopper_and_the_repo_build_dir(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    out = _build.library_path("upsample2x")
    assert out.parent == Path(__file__).resolve().parent.parent / "build" / "kernels"
    cmd = _build.nvcc_command("upsample2x", out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/upsample2x.cu")
