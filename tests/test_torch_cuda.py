"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a machine without a card (a CUDA kernel has no
interpret mode). On the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Shapes are small and odd on purpose: ragged tiles, C not a multiple of the
vector width or of the 64-channel block, and for the conv both its paths
(bf16 with C % 16 == 0 on the tensor cores, the rest on the CUDA cores).
"""

import pytest
import torch

from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_bias_relu_plain
from unet_embroidery_seg_torch.ops.upsample import upsample2x, upsample2x_plain

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
@pytest.mark.parametrize("shape", [(2, 64, 15, 15), (1, 5, 3, 7), (3, 24, 1, 2), (1, 2048, 4, 4)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [(2, 64, 17, 33), (1, 48, 9, 20), (1, 16, 3, 3),  # bf16: tensor-core path
     (1, 24, 9, 5), (1, 130, 8, 16), (2, 3, 1, 1)],  # bf16: CUDA-core path (C % 16)
)
def test_conv3x3_kernel_matches_plain(device, shape, dtype):
    n, c, h, w = shape
    x = _x(shape, dtype, device, seed=c)
    g = torch.Generator(device="cpu").manual_seed(c + 1)
    weight = (torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(device)
    bias = (0.1 * torch.randn(c, generator=g)).to(device)
    before = conv3x3_bias_relu.launches
    got = conv3x3_bias_relu(x, weight, bias)
    torch.cuda.synchronize()
    assert conv3x3_bias_relu.launches == before + 1
    want = conv3x3_bias_relu_plain(x, weight, bias)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, f32_rel=1e-4)  # up to 9*130 terms
