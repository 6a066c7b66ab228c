"""Square SAME 3x3 conv + bias + ReLU: the CUDA kernel, its plain version, its wrapper.

Replaces ``docs/negative-results/pallas_conv.py:conv3x3_same`` (the Pallas
TPU kernel) at the six square decoder convs of unet_resnet50,
``up_concat{4,3,2,1}.conv2`` and ``up_conv.1`` / ``up_conv.3``, which the JAX
package computes with a flax ``nn.Conv`` (``models/blocks.py:conv3x3``).
Every one of those sites adds a bias and applies ReLU right after the conv,
so the kernel does both in its epilogue and the plain version does the same.

- Kernel: ``csrc/conv3x3_same.cu``. 408 GFLOP per forward at 480^2, batch 8,
  bf16; its bound on the H100 is ~420 us, set by operations at C >= 128 and
  by bytes and operations alike at C = 64.
  An implicit GEMM over a shared-memory halo tile with f32 accumulation:
  bf16 with C % 16 == 0 (every site) runs on the tensor cores through
  ``mma.sync``, everything else on the CUDA cores (see ``PERF.md``).
- Plain version: ``conv3x3_bias_relu_plain``, nine shifted-slice products
  accumulated in float32, the arithmetic of the Pallas kernel's per-row
  im2col GEMMs.
- Wrapper: ``conv3x3_bias_relu``. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises on what the kernel does not
  take. ``conv3x3_bias_relu.launches`` counts kernel launches and nothing
  else.

Weights are OIHW (``nn.Conv2d``'s layout); the wrapper repacks them once per
call to [ky][kx][co][ci] in the activation type. The bias stays float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_embroidery_seg_torch.ops import _build

__all__ = ["conv3x3_bias_relu", "conv3x3_bias_relu_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be NCHW, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"conv3x3: needs a ({c}, {c}, 3, 3) weight and a ({c},) bias for "
            f"{c} channels, got {tuple(weight.shape)} and {tuple(bias.shape)}"
        )


def conv3x3_bias_relu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) as nine shifted-slice products.

    The weights are rounded to ``x.dtype`` (as the kernel reads them), then
    everything is accumulated in float32 and the result cast to ``x.dtype``.
    """
    _check_shapes(x, weight, bias)
    n, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = weight.to(x.dtype).float()
    acc = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            acc += torch.einsum(
                "nihw,oi->nohw", xp[:, :, ky : ky + h, kx : kx + w], wf[:, :, ky, kx]
            )
    y = torch.relu(acc + bias.float()[None, :, None, None])
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def conv3x3_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) for an NCHW tensor (channels_last on the card)."""
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    _check_shapes(x, weight, bias)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"conv3x3: needs float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: the CUDA kernel needs channels_last memory")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("conv3x3: x, weight and bias must be on one device")
    n, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    wt = weight.to(x.dtype).permute(2, 3, 0, 1).contiguous()  # OIHW -> [ky][kx][co][ci]
    b = bias.float().contiguous()
    fn = _build.load("conv3x3_same", "conv3x3_bias_relu_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                  _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "conv3x3")
    conv3x3_bias_relu.launches += 1
    return out


conv3x3_bias_relu.launches = 0
