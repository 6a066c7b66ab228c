"""Square SAME 3x3 conv + bias + ReLU: the CUDA kernel, its plain version, its wrapper.

Replaces ``docs/negative-results/pallas_conv.py:conv3x3_same`` (the Pallas
TPU kernel) at the six square decoder convs of unet_resnet50,
``up_concat{4,3,2,1}.conv2`` and ``up_conv.1`` / ``up_conv.3``, which the JAX
package computes with a flax ``nn.Conv`` (``models/blocks.py:conv3x3``).
Every one of those sites adds a bias and applies ReLU right after the conv,
so the kernel does both in its epilogue and the plain version does the same.

- Kernel: ``csrc/conv3x3_same.cu``. 408 GFLOP per forward at 480^2, batch 8,
  bf16; its bound on the H100 is ~420 us, set by operations at C >= 128 and
  by bytes and operations alike at C = 64. bf16 with C % 16 == 0 (every
  site) is an implicit GEMM on the tensor cores (TMA halo ring, ``wgmma``):
  ``c64_persistent`` for C <= 64, ``wgmma`` above; everything else runs on
  the CUDA cores (``fma``). ``conv3x3_path`` names the path a call takes.
- Plain version: ``conv3x3_bias_relu_plain``, nine shifted-slice products
  accumulated in float32, the arithmetic of the Pallas kernel's per-row
  im2col GEMMs.
- Wrapper: ``conv3x3_bias_relu``. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises on what the kernel does not
  take. ``conv3x3_bias_relu.launches`` counts kernel launches and nothing
  else.

Weights are OIHW (``nn.Conv2d``'s layout). ``pack_conv3x3_weight`` puts them
in the kernel's layout. With grad mode off (predict) the wrapper packs a
weight once per parameter version and keeps the packed copy, and the
float32 bias, until the parameter is updated in place, given a new storage,
or freed; with grad on it packs on every call (``_packed_params``, which
also states what the cache cannot see).
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from unet_embroidery_seg_torch.ops import _build

__all__ = ["conv3x3_bias_relu", "conv3x3_bias_relu_plain", "conv3x3_path", "pack_conv3x3_weight"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_FMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
CHUNK = 64  # input channels per halo stage of the tensor-core path


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be NCHW, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"conv3x3: needs a ({c}, {c}, 3, 3) weight and a ({c},) bias for "
            f"{c} channels, got {tuple(weight.shape)} and {tuple(bias.shape)}"
        )


def conv3x3_path(c: int, dtype: torch.dtype) -> str:
    """The kernel path a CUDA call with ``c`` channels of ``dtype`` takes."""
    if dtype == torch.bfloat16 and c % 16 == 0:
        return "c64_persistent" if c <= CHUNK else "wgmma"
    return "fma"


def _tc_layout(c: int, path: str) -> tuple[int, int]:
    """(input-channel chunks, padded output channels) of the tensor-core layout."""
    bn = 64 if path == "c64_persistent" else 128
    return -(-c // CHUNK), -(-c // bn) * bn


def pack_conv3x3_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An OIHW (C, C, 3, 3) weight in the layout the kernel reads, in ``dtype``.

    - ``c64_persistent`` / ``wgmma``: [tap = ky*3 + kx][input-channel chunk of
      64][co_pad][64], zero where C_in or C_out is padded (co_pad is C rounded
      up to the kernel's 64 or 128 output channels per tile).
    - ``fma``: [ky][kx][co][ci].
    """
    c = weight.shape[0]
    w = weight.detach().to(dtype).permute(2, 3, 0, 1)  # [ky][kx][co][ci]
    path = conv3x3_path(c, dtype)
    if path == "fma":
        return w.contiguous()
    chunks, co_pad = _tc_layout(c, path)
    w = F.pad(w, (0, chunks * CHUNK - c, 0, co_pad - c))  # [ky][kx][co_pad][chunks*64]
    return w.reshape(9, co_pad, chunks, CHUNK).permute(0, 2, 1, 3).contiguous()


# (id weight, id bias, dtype) -> (weight ptr, version, bias ptr, version,
# packed weight, f32 bias). An entry goes when its weight or bias is freed
# (``weakref.finalize``), so a later tensor with a reused id never sees it,
# and it serves only at the pointers and versions it was made at: an
# in-place update (``_version``) or a new storage (``p.data = t``) repacks.
_packed: dict[tuple, tuple] = {}


def _version(t: torch.Tensor) -> int | None:
    return None if t.is_inference() else t._version  # inference tensors keep no counter


def _packed_params(weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype):
    """The packed weight and f32 bias, cached only while grad mode is off.

    With grad on (training) the weights change every step, so each call
    packs. Grad off (``no_grad``, ``inference_mode``: predict) caches one
    packing per parameter version. An update made through ``p.data``
    (``p.data.mul_(...)``) bypasses the version counter, as it bypasses
    autograd, and is not seen there: update parameters in place under
    ``torch.no_grad()`` instead, or assign a new tensor.
    """
    wv, bv = _version(weight), _version(bias)
    if torch.is_grad_enabled() or wv is None or bv is None:
        return pack_conv3x3_weight(weight, dtype), bias.detach().float().contiguous()
    key = (id(weight), id(bias), dtype)
    state = (weight.data_ptr(), wv, bias.data_ptr(), bv)
    hit = _packed.get(key)
    if hit is not None and hit[:4] == state:
        return hit[4], hit[5]
    if hit is None:
        for t in (weight, bias):
            weakref.finalize(t, _packed.pop, key, None)
    packed, b = pack_conv3x3_weight(weight, dtype), bias.detach().float().contiguous()
    _packed[key] = (*state, packed, b)
    return packed, b


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
    path = conv3x3_path(c, x.dtype)
    if path != "fma" and x.data_ptr() % 16 != 0:
        raise ValueError("conv3x3: the tensor-core path needs a 16-byte aligned input (TMA)")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    packed, b = _packed_params(weight, bias, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if path == "fma":
            fn = _build.load("conv3x3_same", "conv3x3_fma_launch", _FMA_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                      _DTYPE_CODES[x.dtype], stream)
        else:
            fn = _build.load("conv3x3_same", "conv3x3_wgmma_launch", _WGMMA_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                      stream)
    _build.check(code, "conv3x3")
    conv3x3_bias_relu.launches += 1
    return out


conv3x3_bias_relu.launches = 0
