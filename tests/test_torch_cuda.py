"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a machine without a card (a CUDA kernel has no
interpret mode). On the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Shapes are small and odd on purpose: ragged tiles, C not a multiple of the
vector width or of the 64-channel block, and for the conv each of its paths
(bf16 with C % 16 == 0 on the tensor cores: ``c64_persistent`` for C <= 64,
its operands swapped (the weights as A, the pixels as B), at every pad,
``wgmma`` above, in clusters of two CTAs, also at halo pads and odd tile
counts; f32 with C % 4 == 0 on the TF32 tensor cores,
``tf32x3_c64`` for C <= 64 (also at halo pads), ``tf32x3`` above, held to
f32's tolerance; the rest on the CUDA cores, ``fma``). The backward kernels
(upsample2x's, conv3x3's dgrad) run at the same shapes, and the autograd
Functions' gradients are held against the plain versions' autograd. The
bias-free conv (``conv3x3_same``, epilogue off) runs at the same paths and
at C = 1024, the widest DoubleConv of unet_plain and attention_unet.
"""

import pytest
import torch

from unet_embroidery_seg_torch.ops import conv3x3 as conv3x3_mod
from unet_embroidery_seg_torch.ops.conv3x3 import (
    conv3x3_bias_relu,
    conv3x3_bias_relu_plain,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_same,
    conv3x3_same_plain,
)
from unet_embroidery_seg_torch.ops.upsample import (
    upsample2x,
    upsample2x_backward,
    upsample2x_backward_plain,
    upsample2x_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g).to(device=device, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _tol(ref: torch.Tensor, f32_rel: float) -> float:
    # f32: summation order only, ``f32_rel`` of the largest value. bf16: both
    # sides compute in f32 from the same bf16 inputs, so the results may round
    # to neighbouring bf16 values: one ulp, at most 2^-7 of the largest value.
    scale = ref.abs().max().item()
    return (2.0 ** -7 if ref.dtype == torch.bfloat16 else f32_rel) * scale + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize(
    "shape",
    [(2, 64, 15, 15), (1, 5, 3, 7), (3, 24, 1, 2), (1, 2048, 4, 4),
     (2, 72, 9, 21),    # 2W = 42: not a multiple of the 32-column tile; C: a partial chunk
     (1, 64, 1, 40)],   # H = 1
)
def test_upsample_kernel_matches_plain(device, shape, align_corners, dtype):
    x = _x(shape, dtype, device, seed=sum(shape))
    before = upsample2x.launches
    got = upsample2x(x, align_corners)
    torch.cuda.synchronize()
    assert upsample2x.launches == before + 1
    want = upsample2x_plain(x, align_corners)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-5)  # <= 4-term lerps


def test_upsample_kernel_rejects_nchw_contiguous(device):
    with pytest.raises(ValueError, match="channels_last"):
        upsample2x(torch.zeros(1, 4, 3, 3, device=device), True)


def _conv_params(c, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    weight = (torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(device)
    bias = (0.1 * torch.randn(c, generator=g)).to(device)
    return weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [(2, 64, 17, 33), (1, 48, 9, 20), (1, 16, 3, 3),  # bf16: c64_persistent
     (1, 64, 37, 45), (3, 64, 480, 17),               # ragged H, W; more tiles than CTAs
     (4, 64, 256, 256),                                # 1024 tiles on ~132 CTAs
     (2, 128, 9, 30), (1, 256, 30, 31), (1, 512, 15, 15), (1, 80, 11, 13),  # bf16: wgmma
     (8, 128, 120, 120),                               # 960 items on ~132 CTAs
     (1, 24, 9, 5), (1, 130, 8, 16), (2, 3, 1, 1)],   # bf16: fma (C % 16)
)
@pytest.mark.parametrize("relu_input", [False, True])  # signed (any input; dgrad) / the decoder's
def test_conv3x3_kernel_matches_plain(device, shape, dtype, relu_input):
    n, c, h, w = shape
    x = _x(shape, dtype, device, seed=c)
    if relu_input:
        x = torch.relu(x)
    weight, bias = _conv_params(c, device, seed=c + 1)
    before = conv3x3_bias_relu.launches
    got = conv3x3_bias_relu(x, weight, bias)
    torch.cuda.synchronize()
    assert conv3x3_bias_relu.launches == before + 1
    want = conv3x3_bias_relu_plain(x, weight, bias)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)  # up to 9*512 terms


@pytest.mark.parametrize("c", [64, 256])
def test_conv3x3_kernel_sees_in_place_weight_update(device, c):
    # With grad off the wrapper caches packed weights per parameter version:
    # an in-place update must repack, never serve the stale copy.
    x = _x((1, c, 12, 20), torch.bfloat16, device, seed=3)
    weight, bias = _conv_params(c, device, seed=4)
    with torch.no_grad():
        first = conv3x3_bias_relu(x, weight, bias)
        assert (id(weight), id(bias), torch.bfloat16) in conv3x3_mod._packed
        weight.mul_(-1.0)
        bias.add_(0.05)
        second = conv3x3_bias_relu(x, weight, bias)
    torch.cuda.synchronize()
    want = conv3x3_bias_relu_plain(x, weight, bias)
    assert (second.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)
    assert not torch.equal(first, second)


def test_conv3x3_tensor_core_path_rejects_misaligned_input(device):
    base = torch.zeros(4 * 4 * 64 + 1, dtype=torch.bfloat16, device=device)
    x = base[1:].view(1, 4, 4, 64).permute(0, 3, 1, 2)  # channels_last, 2-byte offset
    weight, bias = _conv_params(64, device, seed=0)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3_bias_relu(x, weight, bias)


UPSAMPLE_BWD_SHAPES = [(2, 64, 15, 15), (1, 5, 3, 7), (3, 24, 1, 2), (1, 2048, 4, 4),
                       (2, 72, 9, 21), (1, 64, 1, 40), (2, 128, 16, 16),
                       # across band and strip edges, a partial last band and strip
                       (2, 64, 40, 70), (1, 256, 33, 17), (1, 16, 37, 50),
                       (1, 64, 1, 1), (2, 8, 23, 1), (1, 128, 1, 33)]  # H = 1, W = 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape", UPSAMPLE_BWD_SHAPES)
def test_upsample_backward_kernel_matches_plain(device, shape, align_corners, dtype):
    n, c, h, w = shape
    g = _x((n, c, 2 * h, 2 * w), dtype, device, seed=sum(shape) + 1)
    before = upsample2x_backward.launches
    got = upsample2x_backward(g, align_corners)
    torch.cuda.synchronize()
    assert upsample2x_backward.launches == before + 1
    want = upsample2x_backward_plain(g, align_corners)
    assert got.shape == (n, c, h, w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    # f32: at most 16 taps summed in another order. bf16: one ulp (see _tol).
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,skip", [("cat_slice", 24), ("nchw", 24),
                                         ("cat_slice", 5)])  # 5: not a vector: VEC = 1
def test_upsample_backward_reads_strided_gradients(device, layout, skip, dtype):
    # The decoder's gradient is a channel slice of torch.cat's (read in
    # place); a plain NCHW gradient is copied to channels_last first.
    c, h, w = 64, 6, 10
    full = _x((2, skip + c, 2 * h, 2 * w), dtype, device, seed=5)
    g = full[:, skip:] if layout == "cat_slice" else full[:, skip:].contiguous()
    got = upsample2x_backward(g, True)
    want = upsample2x_backward_plain(g.contiguous(), True)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-5)


def test_upsample_backward_is_deterministic(device):
    g = _x((2, 64, 64, 64), torch.bfloat16, device, seed=6)
    assert torch.equal(upsample2x_backward(g, True), upsample2x_backward(g, True))


DGRAD_SHAPES = [(2, 64, 17, 33), (1, 48, 9, 20), (3, 64, 480, 17), (2, 128, 9, 30),
                (1, 256, 30, 31), (1, 512, 15, 15), (1, 80, 11, 13), (1, 24, 9, 5), (2, 3, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DGRAD_SHAPES)
def test_conv3x3_dgrad_kernel_matches_plain(device, shape, dtype):
    n, c, h, w = shape
    g = _x(shape, dtype, device, seed=c + 7)  # signed, like a gradient
    weight, _ = _conv_params(c, device, seed=c + 8)
    before = conv3x3_dgrad.launches
    got = conv3x3_dgrad(g, weight)
    torch.cuda.synchronize()
    assert conv3x3_dgrad.launches == before + 1
    want = conv3x3_dgrad_plain(g, weight)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 20, 24), (1, 256, 12, 10), (1, 24, 9, 5)])
def test_conv3x3_function_grads_match_plain_autograd(device, shape, dtype):
    n, c, h, w = shape
    x = torch.relu(_x(shape, dtype, device, seed=c + 9)).requires_grad_()
    weight, bias = _conv_params(c, device, seed=c + 10)
    weight.requires_grad_()
    bias.requires_grad_()
    g = _x(shape, dtype, device, seed=c + 11)
    before = (conv3x3_bias_relu.launches, conv3x3_dgrad.launches)
    y = conv3x3_bias_relu(x, weight, bias)
    got = torch.autograd.grad(y, (x, weight, bias), g)
    assert (conv3x3_bias_relu.launches, conv3x3_dgrad.launches) == (before[0] + 1, before[1] + 1)
    y_ref = conv3x3_bias_relu_plain(x, weight, bias)  # differentiable torch ops
    want = torch.autograd.grad(y_ref, (x, weight, bias), g)
    for name, a, b in zip(("dx", "dW", "db"), got, want):
        assert a.dtype == b.dtype, name
        # bf16: the ReLU masks may differ where y rounds differently (one
        # ulp); dW and db sum over every pixel, so hold them to 2% of scale.
        tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * b.abs().max().item() + 1e-6
        assert (a.float() - b.float()).abs().max().item() <= tol, name


SAME_SHAPES = [(2, 64, 17, 33), (1, 48, 9, 20), (1, 128, 30, 32), (1, 256, 15, 15),
               (1, 512, 7, 9), (1, 1024, 3, 5), (2, 1024, 4, 4),  # wgmma: 16 chunks of 64
               (1, 80, 11, 13), (1, 24, 9, 5), (2, 3, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SAME_SHAPES)
def test_conv3x3_same_kernel_matches_plain(device, shape, dtype):
    n, c, h, w = shape
    x = torch.relu(_x(shape, dtype, device, seed=c + 12))  # the DoubleConv feeds it a ReLU
    weight, _ = _conv_params(c, device, seed=c + 13)
    before = (conv3x3_same.launches, conv3x3_bias_relu.launches)
    got = conv3x3_same(x, weight)
    torch.cuda.synchronize()
    assert (conv3x3_same.launches, conv3x3_bias_relu.launches) == (before[0] + 1, before[1])
    want = conv3x3_same_plain(x, weight)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1024, 3, 5), (2, 1024, 4, 4)])
def test_conv3x3_dgrad_kernel_matches_plain_at_1024_channels(device, shape, dtype):
    g = _x(shape, dtype, device, seed=shape[2] + 14)
    weight, _ = _conv_params(shape[1], device, seed=15)
    got = conv3x3_dgrad(g, weight)
    want = conv3x3_dgrad_plain(g, weight)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)


# dgrad on the forward's packing (``pack_conv3x3_grad``), per path: bf16
# c64_persistent and wgmma read it flipped and transposed in the kernel,
# tf32x3 reads the packing's dgrad planes, fma flips by index.
DGRAD_PACK_CASES = [((2, 64, 17, 33), torch.bfloat16), ((1, 48, 9, 20), torch.bfloat16),
                    ((2, 128, 9, 30), torch.bfloat16), ((1, 192, 11, 13), torch.bfloat16),
                    ((1, 1024, 4, 6), torch.bfloat16),
                    ((2, 64, 17, 33), torch.float32), ((1, 192, 9, 20), torch.float32),
                    ((1, 24, 9, 5), torch.bfloat16), ((2, 3, 5, 4), torch.float32),
                    ((1, 130, 8, 16), torch.float32)]


@pytest.mark.parametrize("pad", [(1, 1), (2, 1), (0, 2)])
@pytest.mark.parametrize("shape,dtype", DGRAD_PACK_CASES)
def test_conv3x3_dgrad_on_the_forward_packing_equals_the_flipped_packing(device, shape, dtype,
                                                                        pad):
    c = shape[1]
    g = _x(shape, dtype, device, seed=c + 21)
    weight, _ = _conv_params(c, device, seed=c + 22)
    weight = weight.contiguous(memory_format=torch.channels_last)  # as the models hold it
    packed = conv3x3_mod.pack_conv3x3_grad(weight, dtype)
    got = conv3x3_dgrad(g, weight, pad, packed)
    # the forward kernel on the weights flipped, transposed and packed for the call
    flipped = conv3x3_mod.pack_conv3x3_weight(conv3x3_mod._dgrad_weight(weight), dtype)
    want = conv3x3_mod._launch(g, flipped, None, "flipped dgrad", pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the same products summed in the same order


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("c", [4, 36, 64, 192, 1024])
def test_tf32x3_grad_pack_kernel_equals_both_packings(device, c, layout):
    weight, _ = _conv_params(c, device, seed=c + 23)
    if layout == "channels_last":
        weight = weight.contiguous(memory_format=torch.channels_last)
    before = conv3x3_mod.pack_conv3x3_grad.launches
    got = conv3x3_mod.pack_conv3x3_grad(weight, torch.float32)
    assert conv3x3_mod.pack_conv3x3_grad.launches == before + 1
    want = torch.stack([conv3x3_mod.pack_conv3x3_weight(w, torch.float32)
                        for w in (weight, conv3x3_mod._dgrad_weight(weight))])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_conv3x3_function_backward_packs_nothing(device, dtype, fused, monkeypatch):
    c = 128
    x = torch.relu(_x((2, c, 12, 10), dtype, device, seed=24)).requires_grad_()
    weight, bias = _conv_params(c, device, seed=25)
    weight.requires_grad_()
    g = _x((2, c, 12, 10), dtype, device, seed=26)
    y = conv3x3_bias_relu(x, weight, bias) if fused else conv3x3_same(x, weight)

    def refuse(*args, **kwargs):
        raise AssertionError("packed in the backward")

    packed = conv3x3_mod.pack_conv3x3_grad(weight, dtype)
    monkeypatch.setattr(conv3x3_mod, "pack_conv3x3_grad", refuse)
    monkeypatch.setattr(conv3x3_mod, "pack_conv3x3_weight", refuse)
    (dx,) = torch.autograd.grad(y, (x,), g)
    g_pre = torch.where(y > 0, g, 0) if fused else g
    assert torch.equal(dx, conv3x3_dgrad(g_pre, weight, packed=packed))


def test_conv3x3_same_cache_sees_in_place_weight_update(device):
    x = _x((1, 128, 12, 20), torch.bfloat16, device, seed=16)
    weight, _ = _conv_params(128, device, seed=17)
    with torch.no_grad():
        first = conv3x3_same(x, weight)
        assert (id(weight), None, torch.bfloat16) in conv3x3_mod._packed
        weight.mul_(-0.5)
        second = conv3x3_same(x, weight)
    want = conv3x3_same_plain(x, weight)
    assert (second.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)
    assert not torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 20, 24), (1, 1024, 4, 6), (1, 24, 9, 5)])
def test_conv3x3_same_function_grads_match_plain_autograd(device, shape, dtype):
    c = shape[1]
    x = torch.relu(_x(shape, dtype, device, seed=c + 18)).requires_grad_()
    weight, _ = _conv_params(c, device, seed=c + 19)
    weight.requires_grad_()
    g = _x(shape, dtype, device, seed=c + 20)
    before = (conv3x3_same.launches, conv3x3_dgrad.launches)
    got = torch.autograd.grad(conv3x3_same(x, weight), (x, weight), g)
    assert (conv3x3_same.launches, conv3x3_dgrad.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(conv3x3_same_plain(x, weight), (x, weight), g)
    for name, a, b in zip(("dx", "dW"), got, want):
        assert a.dtype == b.dtype, name
        # bf16: dW sums over every pixel (cuDNN's wgrad against f32 sums): 2% of scale.
        tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * b.abs().max().item() + 1e-6
        assert (a.float() - b.float()).abs().max().item() <= tol, name


# --- tf32x3: the f32 path on the TF32 tensor cores (3xTF32) ---------------------------

TF32X3_SHAPES = [(1, 32, 8, 16),     # one 16 x 8 tile, one chunk
                 (2, 64, 17, 33),    # N = 64 tiles, ragged H and W
                 (1, 96, 9, 20),     # 3 chunks; 96 of 128 output channels, the rest clipped
                 (2, 36, 7, 9),      # C % 32 != 0: TMA's zero fill pads the last chunk
                 (1, 4, 5, 6),       # the fewest channels the path takes
                 (2, 128, 30, 32), (1, 256, 15, 15),
                 (1, 1024, 3, 5), (2, 1024, 4, 4),  # 32 chunks of 32
                 (1, 128, 1, 1), (3, 64, 120, 17)]  # H = W = 1; more tiles than CTAs


@pytest.mark.parametrize("fn", ["bias_relu", "same", "dgrad"])
@pytest.mark.parametrize("shape", TF32X3_SHAPES)
def test_tf32x3_kernel_matches_plain(device, shape, fn):
    n, c, h, w = shape
    assert conv3x3_mod.conv3x3_path(c, torch.float32) == ("tf32x3_c64" if c <= 64 else "tf32x3")
    x = _x(shape, torch.float32, device, seed=c + h + 21)  # signed
    weight, bias = _conv_params(c, device, seed=c + 22)
    run, plain, counter = {
        "bias_relu": (lambda: conv3x3_bias_relu(x, weight, bias),
                      lambda: conv3x3_bias_relu_plain(x, weight, bias), conv3x3_bias_relu),
        "same": (lambda: conv3x3_same(x, weight), lambda: conv3x3_same_plain(x, weight),
                 conv3x3_same),
        "dgrad": (lambda: conv3x3_dgrad(x, weight), lambda: conv3x3_dgrad_plain(x, weight),
                  conv3x3_dgrad),
    }[fn]
    before = counter.launches
    with torch.no_grad():
        got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = plain()
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    # f32-accurate: about 2^-21 of each product, summed over 9*C terms in
    # another order: within 1e-4 of the largest value, as f32 on the CUDA cores.
    assert (got - want).abs().max().item() <= _tol(want, f32_rel=1e-4)


@pytest.mark.parametrize("pad", [(1, 1), (0, 1), (1, 2)])
@pytest.mark.parametrize("fn", ["bias_relu", "same", "dgrad"])
@pytest.mark.parametrize("c", [16, 48, 64])
def test_tf32x3_c64_kernel_matches_plain_at_each_pad(device, c, fn, pad):
    # The C <= 64 variant (two pipelines per CTA, each streaming its own
    # weights) in both launch modes (MODE_BIAS_RELU; MODE_CONV, which the
    # bias-free forward and the f32 dgrad take) at SAME and halo pads.
    assert conv3x3_mod.conv3x3_path(c, torch.float32) == "tf32x3_c64"
    shape = (2, c, 37, 45)  # ragged tiles; 48: a half-empty second chunk
    x = _x(shape, torch.float32, device, seed=c + sum(pad) + 27)
    weight, bias = _conv_params(c, device, seed=c + 28)
    run, plain, counter = {
        "bias_relu": (lambda: conv3x3_bias_relu(x, weight, bias, pad),
                      lambda: conv3x3_bias_relu_plain(x, weight, bias, pad), conv3x3_bias_relu),
        "same": (lambda: conv3x3_same(x, weight, pad), lambda: conv3x3_same_plain(x, weight, pad),
                 conv3x3_same),
        "dgrad": (lambda: conv3x3_dgrad(x, weight, pad), lambda: conv3x3_dgrad_plain(x, weight, pad),
                  conv3x3_dgrad),
    }[fn]
    before = (counter.launches, counter.halo_launches)
    with torch.no_grad():
        got = run()
    torch.cuda.synchronize()
    assert (counter.launches, counter.halo_launches) == (before[0] + 1,
                                                         before[1] + (pad != (1, 1)))
    want = plain()
    assert got.shape == (2, c, 37 + sum(pad) - 2, 45)
    assert (got - want).abs().max().item() <= _tol(want, f32_rel=1e-4)  # f32, 9*C terms


@pytest.mark.parametrize("pad", [(1, 1), (1, 0), (0, 1), (1, 2), (2, 1), (0, 2)])
@pytest.mark.parametrize("fn", ["bias_relu", "same", "dgrad"])
@pytest.mark.parametrize("shape", [(1, 80, 19, 21), (1, 1024, 9, 37), (3, 192, 15, 23)])
def test_wgmma_clusters_match_plain_at_each_pad(device, shape, fn, pad):
    # The bf16 streamed layout: clusters of two CTAs, each loading half of
    # every weight stage into both (TMA multicast). C = 80: one channel tile,
    # a half-empty second chunk; 1024: 8 channel tiles, 16 chunks; 192: a
    # half-empty second channel tile. Each shape has an odd count of pixel
    # tiles at SAME pads, so the last cluster item's partner stores nothing.
    n, c, h, w = shape
    assert conv3x3_mod.conv3x3_path(c, torch.bfloat16) == "wgmma"
    assert conv3x3_mod.streamed_schedule(n, h, w, c)["pix_tiles"] % 2 == 1
    x = _x(shape, torch.bfloat16, device, seed=c + sum(pad) + 31)
    weight, bias = _conv_params(c, device, seed=c + 32)
    run, plain, counter = {
        "bias_relu": (lambda: conv3x3_bias_relu(torch.relu(x), weight, bias, pad),
                      lambda: conv3x3_bias_relu_plain(torch.relu(x), weight, bias, pad),
                      conv3x3_bias_relu),
        "same": (lambda: conv3x3_same(x, weight, pad), lambda: conv3x3_same_plain(x, weight, pad),
                 conv3x3_same),
        "dgrad": (lambda: conv3x3_dgrad(x, weight, pad), lambda: conv3x3_dgrad_plain(x, weight, pad),
                  conv3x3_dgrad),
    }[fn]
    before = (counter.launches, counter.halo_launches)
    with torch.no_grad():
        got = run()
    torch.cuda.synchronize()
    assert (counter.launches, counter.halo_launches) == (before[0] + 1,
                                                         before[1] + (pad != (1, 1)))
    want = plain()
    assert got.shape == (n, c, h + sum(pad) - 2, w)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=0.0)


@pytest.mark.parametrize("pad", [(1, 1), (1, 0), (0, 1), (1, 2), (2, 1), (0, 2)])
@pytest.mark.parametrize("fn", ["bias_relu", "same", "dgrad"])
@pytest.mark.parametrize("shape", [(1, 16, 19, 21), (8, 32, 17, 45), (1, 48, 33, 13),
                                   (8, 64, 40, 70)])
def test_c64_swapped_operands_match_plain_at_each_pad(device, shape, fn, pad):
    # The bf16 C <= 64 kernel: M = output channels (the resident weights), N =
    # 256 pixels of the halo stage at the tap's shift, at the pitch TW + 2.
    # Widths 21, 45, 13, 70 leave a ragged last tile at each tile shape the
    # launch picks (TW 14, 30, 40); C = 16, 32, 48 read zero-filled channels.
    n, c, h, w = shape
    assert conv3x3_mod.conv3x3_path(c, torch.bfloat16) == "c64_persistent"
    assert w % conv3x3_mod.pick_tile_c64(h + sum(pad) - 2, w)[1] != 0
    x = _x(shape, torch.bfloat16, device, seed=c + sum(pad) + 41)
    weight, bias = _conv_params(c, device, seed=c + 42)
    run, plain, counter = {
        "bias_relu": (lambda: conv3x3_bias_relu(torch.relu(x), weight, bias, pad),
                      lambda: conv3x3_bias_relu_plain(torch.relu(x), weight, bias, pad),
                      conv3x3_bias_relu),
        "same": (lambda: conv3x3_same(x, weight, pad), lambda: conv3x3_same_plain(x, weight, pad),
                 conv3x3_same),
        "dgrad": (lambda: conv3x3_dgrad(x, weight, pad), lambda: conv3x3_dgrad_plain(x, weight, pad),
                  conv3x3_dgrad),
    }[fn]
    before = (counter.launches, counter.halo_launches)
    with torch.no_grad():
        got = run()
    torch.cuda.synchronize()
    assert (counter.launches, counter.halo_launches) == (before[0] + 1,
                                                         before[1] + (pad != (1, 1)))
    want = plain()
    assert got.shape == (n, c, h + sum(pad) - 2, w)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=0.0)


@pytest.mark.parametrize("tap", [4, 0, 8, 5])  # centre, the two corners, a side
@pytest.mark.parametrize("c", [32, 64])
def test_tf32x3_a_fragment_on_one_tile_is_exact(device, c, tap):
    # One 16 x 8 tile. Each input value names its pixel and channel and is an
    # integer below 2^10 (exact in tf32, so its small part is 0); the weight
    # is the identity between channels at one tap. Each output is then one
    # input value moved by the tap's shift, exactly: a wrong row or column of
    # the register fragment, or a wrong shift or swizzle, gives another value.
    h, w = 8, 16
    idx = torch.arange(h * w * c, dtype=torch.float32).view(1, h, w, c)
    x = ((idx * 37) % 1021 - 510).permute(0, 3, 1, 2).to(device)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.zeros(c, c, 3, 3, device=device)
    weight[:, :, tap // 3, tap % 3] = torch.eye(c, device=device)
    got = conv3x3_same(x, weight)
    want = conv3x3_same_plain(x, weight)
    assert torch.equal(got, want)
    assert got.abs().max().item() > 0


def test_tf32x3_keeps_the_bits_one_tf32_pass_loses(device):
    # x = 1 + 2^-20 (its tf32 part is 1, the rest lives in the small part),
    # weight 1 at the centre tap: a single TF32 pass would give 1.0.
    c = 32
    x = torch.full((1, c, 8, 16), 1.0 + 2.0 ** -20, device=device)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.zeros(c, c, 3, 3, device=device)
    weight[:, :, 1, 1] = torch.eye(c, device=device) * (1.0 + 2.0 ** -19)
    got = conv3x3_same(x, weight)
    want = conv3x3_same_plain(x, weight)  # (1 + 2^-20)(1 + 2^-19), rounded to f32
    assert (got - want).abs().max().item() <= 2.0 ** -22


def test_tf32x3_path_rejects_misaligned_input(device):
    base = torch.zeros(4 * 4 * 64 + 1, device=device)
    x = base[1:].view(1, 4, 4, 64).permute(0, 3, 1, 2)  # channels_last, 4-byte offset
    weight, bias = _conv_params(64, device, seed=0)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3_bias_relu(x, weight, bias)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 6), (torch.float32, 130), (torch.float32, 3),
                                     (torch.bfloat16, 24), (torch.bfloat16, 40)])
@pytest.mark.parametrize("fn", ["bias_relu", "same", "dgrad"])
def test_fma_takes_the_channels_the_tensor_cores_do_not(device, dtype, c, fn):
    assert conv3x3_mod.conv3x3_path(c, dtype) == "fma"
    x = _x((2, c, 9, 13), dtype, device, seed=c + 23)
    weight, bias = _conv_params(c, device, seed=c + 24)
    got, want = {
        "bias_relu": lambda: (conv3x3_bias_relu(x, weight, bias), conv3x3_bias_relu_plain(x, weight, bias)),
        "same": lambda: (conv3x3_same(x, weight), conv3x3_same_plain(x, weight)),
        "dgrad": lambda: (conv3x3_dgrad(x, weight), conv3x3_dgrad_plain(x, weight)),
    }[fn]()
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)


def test_fma_path_still_runs_f32_at_tensor_core_channels_when_asked(device):
    # chip_smoke.py times the CUDA-core kernel beside tf32x3 at the model's
    # f32 sites: the fma layout and launch at C = 128, f32.
    x = _x((2, 128, 12, 20), torch.float32, device, seed=25)
    weight, _ = _conv_params(128, device, seed=26)
    packed = conv3x3_mod.pack_conv3x3_weight(weight, torch.float32, path="fma")
    got = conv3x3_mod._launch(x, packed, None, "fma f32", path="fma")
    want = conv3x3_same_plain(x, weight)
    assert (got - want).abs().max().item() <= _tol(want, f32_rel=1e-4)


# A bf16 forward + backward captured (``utils/timing.graph_ms``) after an f32
# one in the same process holds at its first capture. Each dtype's input is
# a leaf copy: ``x0.to(torch.float32)`` would be ``x0`` itself, and requiring
# grad on it would make the bf16 input a non-leaf made on the eager stream,
# whose captured backward loses its capture (``scripts/torch_capture_probe.py``).
@pytest.mark.parametrize("op", ["upsample2x", "conv3x3_bias_relu", "head"])
def test_bf16_capture_holds_after_an_f32_capture(device, op):
    import torch.nn.functional as F

    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    c = 64
    x0 = _x((2, c, 16, 16), torch.float32, device, seed=40)
    weight, bias = (t.requires_grad_() for t in _conv_params(c, device, seed=41))
    head_w = (torch.randn(2, c, 1, 1, generator=torch.Generator().manual_seed(42)) / 8).to(device)
    head_w.requires_grad_()
    fns = {"upsample2x": lambda x: (upsample2x(x, True), [x]),
           "conv3x3_bias_relu": lambda x: (conv3x3_bias_relu(x, weight, bias), [x, weight, bias]),
           "head": lambda x: (F.conv2d(x, head_w), [x, head_w])}

    def graph_ms_of(dtype):
        x = x0.to(dtype, copy=True).requires_grad_(True)
        amp = dtype == torch.bfloat16

        def fwd_bwd():
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp, cache_enabled=False):
                y, inputs = fns[op](x)
            return torch.autograd.grad(y, inputs, torch.ones_like(y))

        return graph_ms(fwd_bwd, event_ms(fwd_bwd, 5.0), 5.0)

    assert graph_ms_of(torch.float32) > 0
    assert graph_ms_of(torch.bfloat16) > 0  # raises if its first capture is invalidated


@pytest.mark.parametrize("cudnn_calls,sync_calls", [(1, 5), (5, 1)])
def test_sync_bn_check_record_is_independent_of_the_timer(device, tmp_path, cudnn_calls,
                                                          sync_calls):
    # chip_smoke.py 12a on its 1-rank NCCL group at its own shape; the timer
    # calls the two sides different numbers of times.
    import sys
    from pathlib import Path

    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    timed = []

    def timer(fn):
        timed.append(sync_calls if len(timed) % 2 else cudnn_calls)
        for _ in range(timed[-1]):
            fn()
        return 0.0

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        result = chip_smoke.sync_bn_check(dist.group.WORLD, timer=timer)
    finally:
        dist.destroy_process_group()
    for label in ("f32", "bf16"):
        assert result[label]["calls"] == {"cudnn": 1 + cudnn_calls, "sync": 1 + sync_calls}
    assert result["f32"]["rel_err"]["dx"] <= chip_smoke.TOL_SYNC_BN["f32"]


def test_spans_record_under_a_card_only_profiler_on_autograd_thread(device):
    # The benchmark's traced stretch profiles the card only: the program's spans must
    # still record there, in a Function's forward and in its backward, which autograd
    # runs on a thread of its own for a card's tensors.
    import threading

    from unet_embroidery_seg_torch.utils import profiling

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            with profiling.span("op.conv3x3"):
                return x * 2

        @staticmethod
        def backward(ctx, g):
            with profiling.span("op.conv3x3_dgrad"):
                return g * 2

    x = torch.ones(1024, device=device, requires_grad=True)
    profiling.clear_spans()
    Twice.apply(x).sum().backward()  # no profiler: nothing recorded
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with profiling.span("step.train"):
            Twice.apply(x).sum().backward()
        torch.cuda.synchronize()
    Twice.apply(x).sum().backward()  # stopped: nothing more
    got = {s[0]: s for s in profiling.spans()}
    profiling.clear_spans()
    assert sorted(got) == ["op.conv3x3", "op.conv3x3_dgrad", "step.train"]
    main = threading.get_ident()
    assert got["op.conv3x3"][3] == got["step.train"][3] == main
    assert got["op.conv3x3"][4] == "step.train"
    assert got["op.conv3x3_dgrad"][3] != main and got["op.conv3x3_dgrad"][4] is None
    root = got["step.train"]
    assert all(root[1] <= s[1] <= s[2] <= root[2] for s in got.values())
