"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a machine without a card (a CUDA kernel has no
interpret mode). On the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Shapes are small and odd on purpose: ragged tiles, C not a multiple of the
vector width or of the 64-channel block, and for the conv each of its paths
(bf16 with C % 16 == 0 on the tensor cores: ``c64_persistent`` for C <= 64,
``wgmma`` above; the rest on the CUDA cores, ``fma``). The backward kernels
(upsample2x's, conv3x3's dgrad) run at the same shapes, and the autograd
Functions' gradients are held against the plain versions' autograd.
"""

import pytest
import torch

from unet_embroidery_seg_torch.ops import conv3x3 as conv3x3_mod
from unet_embroidery_seg_torch.ops.conv3x3 import (
    conv3x3_bias_relu,
    conv3x3_bias_relu_plain,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
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
