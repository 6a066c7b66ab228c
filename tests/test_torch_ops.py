"""The port's ops against the JAX package on the CPU: resize tables, upsample, conv3x3.

Inputs are made by numpy from a seed and handed to both sides. The Pallas
TPU kernels (docs/negative-results/) are loaded by path and run in
interpret mode, as they run on a CPU; nothing in the JAX package changes.
On the CPU the port's wrappers take their plain versions, which these tests
hold against JAX; the CUDA kernels are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_torch.models.resnet_backbone import ResNet50Backbone
from unet_embroidery_seg_torch.ops import _build, resize
from unet_embroidery_seg_torch.ops import conv3x3 as conv3x3_mod
from unet_embroidery_seg_torch.ops.conv3x3 import (
    conv3x3_bias_relu,
    conv3x3_bias_relu_plain,
    conv3x3_path,
    pack_conv3x3_weight,
)
from unet_embroidery_seg_torch.ops.upsample import (
    TILE_SIZES,
    tile_input_span,
    upsample2x,
    upsample2x_plain,
)

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


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("tile", TILE_SIZES)
def test_upsample_tile_taps_fit_the_kernels_staging_area(tile, align_corners):
    # The CUDA kernel stages tile/2 + 2 input rows (columns) per tile of
    # outputs in shared memory; every 2x resize must fit, at every tile.
    for size in range(1, 1100):
        idx0, idx1, _ = resize._linear_coords(size, 2 * size, align_corners)
        assert tile_input_span(idx0, idx1, tile) <= tile // 2 + 2, size


@pytest.mark.parametrize("c,dtype,path", [
    (64, torch.bfloat16, "c64_persistent"), (16, torch.bfloat16, "c64_persistent"),
    (80, torch.bfloat16, "wgmma"), (2048, torch.bfloat16, "wgmma"),
    (24, torch.bfloat16, "fma"), (130, torch.bfloat16, "fma"), (64, torch.float32, "fma"),
])
def test_conv3x3_path_by_dtype_and_channels(c, dtype, path):
    assert conv3x3_path(c, dtype) == path


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


@pytest.mark.parametrize("fn", ["conv3x3_same", "conv3x3_same_plain", "conv3x3_dgrad",
                                "conv3x3_dgrad_plain"])
def test_bias_free_convs_reject_a_wrong_weight_with_value_error(fn):
    # No bias to format: the shape check must still raise its ValueError.
    with pytest.raises(ValueError, match=r"\(4, 4, 3, 3\) weight"):
        getattr(conv3x3_mod, fn)(torch.zeros(1, 4, 5, 5), torch.zeros(4, 3, 3, 3))


# --- conv3x3 weight packing and its cache -------------------------------------------

PACK_CASES = [(64, torch.bfloat16), (48, torch.bfloat16), (80, torch.bfloat16),
              (128, torch.bfloat16), (24, torch.bfloat16), (16, torch.float32)]


def _oihw(c, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(c, c, 3, 3).astype(np.float32))


def _unpack(packed, c, dtype):
    """The OIHW weight back from the kernel's layout."""
    if conv3x3_path(c, dtype) == "fma":  # [ky][kx][co][ci]
        return packed.permute(2, 3, 0, 1)
    chunks, co_pad = packed.shape[1], packed.shape[2]  # [tap][chunk][co_pad][64]
    w = packed.permute(0, 2, 1, 3).reshape(3, 3, co_pad, chunks * 64)[:, :, :c, :c]
    return w.permute(2, 3, 0, 1)


@pytest.mark.parametrize("c,dtype", PACK_CASES)
def test_pack_conv3x3_weight_round_trips(c, dtype):
    weight = _oihw(c, seed=c)
    packed = pack_conv3x3_weight(weight, dtype)
    assert packed.dtype == dtype and packed.is_contiguous()
    if conv3x3_path(c, dtype) != "fma":
        # [tap][C_in chunk of 64][C_out padded to the 64- or 128-channel tile][64]
        bn = 64 if c <= 64 else 128
        assert tuple(packed.shape) == (9, -(-c // 64), -(-c // bn) * bn, 64)
    torch.testing.assert_close(_unpack(packed, c, dtype), weight.to(dtype),
                               rtol=0, atol=0)


def _conv_from_packed(x, packed, bias, c, path):
    """relu(conv + bias) in f32, reading the weights the way the kernel does."""
    n, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    acc = torch.zeros((n, c, h, w))
    for ky in range(3):
        for kx in range(3):
            if path == "fma":  # [ky][kx][co][ci]
                tap = packed[ky, kx]
            else:  # [tap][chunk][co_pad][64]: the chunks side by side are C_in
                chunks = [packed[ky * 3 + kx, k, :c] for k in range(packed.shape[1])]
                tap = torch.cat(chunks, dim=1)[:, :c]
            # One product over all of C_in per tap, as the plain version sums.
            acc += torch.einsum("nihw,oi->nohw", xp[:, :, ky : ky + h, kx : kx + w], tap.float())
    return torch.relu(acc + bias[None, :, None, None])


@pytest.mark.parametrize("c,dtype", PACK_CASES)
def test_conv_reading_the_packed_layout_equals_the_plain_version(c, dtype):
    rng = np.random.RandomState(c + 1)
    x = torch.from_numpy(rng.randn(2, c, 7, 9).astype(np.float32))
    weight, bias = _oihw(c, seed=c) / (3 * c ** 0.5), torch.from_numpy(rng.randn(c).astype(np.float32))
    packed = pack_conv3x3_weight(weight, dtype)
    got = _conv_from_packed(x, packed, bias, c, conv3x3_path(c, dtype))
    # The packed values are the weight rounded to ``dtype``; in f32 from the
    # same rounded weights only the order of the f32 sums differs.
    want = conv3x3_bias_relu_plain(x, weight.to(dtype).float(), bias)
    torch.testing.assert_close(got, want.float(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weight_cache_repacks_after_in_place_update(dtype):
    weight, bias = _oihw(32, seed=1), torch.zeros(32)
    with torch.no_grad():  # the cache serves grad-off calls (predict)
        packed, b = conv3x3_mod._packed_params(weight, bias, dtype)
        again, _ = conv3x3_mod._packed_params(weight, bias, dtype)
        assert again is packed  # one pack per parameter version
        version = weight._version
        weight.add_(1.0)
        assert weight._version != version  # the counter the cache compares
        repacked, _ = conv3x3_mod._packed_params(weight, bias, dtype)
        assert repacked is not packed
        torch.testing.assert_close(repacked, pack_conv3x3_weight(weight, dtype), rtol=0, atol=0)
        bias.add_(0.5)
        _, b2 = conv3x3_mod._packed_params(weight, bias, dtype)
    torch.testing.assert_close(b2, torch.full((32,), 0.5))
    assert b2 is not b


def test_packed_weight_cache_serves_only_the_tensor_it_was_made_from():
    # The entry goes with its weight, so a later tensor (which may reuse the
    # freed one's id and address) never gets the freed tensor's packing.
    weight, bias = _oihw(16, seed=2), torch.zeros(16)
    with torch.no_grad():
        conv3x3_mod._packed_params(weight, bias, torch.bfloat16)
        key = (id(weight), id(bias), torch.bfloat16)
        assert key in conv3x3_mod._packed
        other = weight.clone() * 2.0
        del weight
        gc.collect()
        assert key not in conv3x3_mod._packed
        packed, _ = conv3x3_mod._packed_params(other, bias, torch.bfloat16)
    torch.testing.assert_close(packed, pack_conv3x3_weight(other, torch.bfloat16), rtol=0, atol=0)


def test_packed_weight_cache_repacks_after_new_storage():
    # ``p.data = t`` swaps the storage without touching the version counter.
    weight, bias = torch.nn.Parameter(_oihw(16, seed=3)), torch.nn.Parameter(torch.zeros(16))
    with torch.no_grad():
        packed, _ = conv3x3_mod._packed_params(weight, bias, torch.bfloat16)
        weight.data = _oihw(16, seed=4)
        repacked, _ = conv3x3_mod._packed_params(weight, bias, torch.bfloat16)
    assert repacked is not packed
    torch.testing.assert_close(repacked, pack_conv3x3_weight(_oihw(16, seed=4), torch.bfloat16),
                               rtol=0, atol=0)


def test_packed_weight_cache_packs_every_call_with_grad_on():
    # Training updates weights every step, some through ``.data`` (EMA,
    # clipping), which the version counter does not see: with grad on, each
    # call packs what the weight holds now.
    weight, bias = torch.nn.Parameter(_oihw(16, seed=5)), torch.nn.Parameter(torch.zeros(16))
    packed, _ = conv3x3_mod._packed_params(weight, bias, torch.bfloat16)
    weight.data.mul_(-1.0)
    bias.data.add_(0.25)
    repacked, b = conv3x3_mod._packed_params(weight, bias, torch.bfloat16)
    torch.testing.assert_close(repacked, -packed, rtol=0, atol=0)
    torch.testing.assert_close(b, torch.full((16,), 0.25))
    assert (id(weight), id(bias), torch.bfloat16) not in conv3x3_mod._packed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weight_only_cache_repacks_after_in_place_update_and_goes_with_the_weight(dtype):
    # conv3x3_same's entries: keyed on the weight alone, same version,
    # pointer and clean-up rules as the weight-and-bias entries.
    weight = _oihw(32, seed=6)
    key = (id(weight), None, dtype)
    with torch.no_grad():
        packed, b = conv3x3_mod._packed_params(weight, None, dtype)
        assert b is None and key in conv3x3_mod._packed
        assert conv3x3_mod._packed_params(weight, None, dtype)[0] is packed
        weight.add_(1.0)
        repacked, _ = conv3x3_mod._packed_params(weight, None, dtype)
        assert repacked is not packed
        torch.testing.assert_close(repacked, pack_conv3x3_weight(weight, dtype), rtol=0, atol=0)
        weight.data = _oihw(32, seed=7)  # a new storage, the version counter untouched
        torch.testing.assert_close(conv3x3_mod._packed_params(weight, None, dtype)[0],
                                   pack_conv3x3_weight(_oihw(32, seed=7), dtype), rtol=0, atol=0)
        del weight
        gc.collect()
        assert key not in conv3x3_mod._packed


def test_weight_only_cache_packs_every_call_with_grad_on():
    weight = torch.nn.Parameter(_oihw(16, seed=8))
    packed, _ = conv3x3_mod._packed_params(weight, None, torch.bfloat16)
    weight.data.mul_(-1.0)
    repacked, _ = conv3x3_mod._packed_params(weight, None, torch.bfloat16)
    torch.testing.assert_close(repacked, -packed, rtol=0, atol=0)
    assert (id(weight), None, torch.bfloat16) not in conv3x3_mod._packed


@pytest.mark.parametrize("fn", ["upsample", "conv", "conv_same"])
def test_wrappers_raise_off_cpu_and_cuda(fn):
    # The meta device is neither: no plain fallback, no kernel, an error.
    x = torch.empty(1, 4, 5, 5, device="meta")
    with pytest.raises(ValueError):
        if fn == "upsample":
            upsample2x(x, True)
        elif fn == "conv_same":
            conv3x3_mod.conv3x3_same(x, torch.empty(4, 4, 3, 3, device="meta"))
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
