"""Square SAME 3x3 conv: the CUDA kernel, its plain versions, its wrappers.

Replaces ``docs/negative-results/pallas_conv.py:conv3x3_same`` (the Pallas
TPU kernel) at every square (C_in = C_out) 3x3 conv of the ported models,
which the JAX package computes with a flax ``nn.Conv``
(``models/blocks.py:conv3x3``). Two forms:

- ``conv3x3_bias_relu``: relu(conv + bias), the kernel's epilogue doing
  both. The six square decoder convs of unet_resnet50,
  ``up_concat{4,3,2,1}.conv2`` and ``up_conv.1`` / ``up_conv.3``, add a bias
  and apply ReLU right after the conv.
- ``conv3x3_same``: the bias-free conv alone, the Pallas kernel's own
  function (its epilogue off). The ``conv2`` of every ``DoubleConv`` of
  unet_plain and attention_unet (nine per model, C = 64 to 1024), which BN
  and ReLU follow as stock ops.

- Kernel: ``csrc/conv3x3_same.cu``. 408 GFLOP per forward at 480^2, batch 8,
  bf16; its bound on the H100 is ~420 us, set by operations at C >= 128 and
  by bytes and operations alike at C = 64. bf16 with C % 16 == 0 (every
  site) is an implicit GEMM on the tensor cores (TMA halo ring, ``wgmma``):
  ``c64_persistent`` for C <= 64, ``wgmma`` above; everything else runs on
  the CUDA cores (``fma``). ``conv3x3_path`` names the path a call takes.
- dgrad: the same kernel, as the Pallas kernel's docstring has it: dx is
  the same conv of the output's gradient with the weights flipped in space
  and transposed in channels, the epilogue's bias and ReLU off
  (``conv3x3_dgrad``). wgrad is cuDNN's (``torch.nn.grad.conv2d_weight``):
  the Pallas kernel never computed it, the JAX package left it to XLA.
- Plain versions: ``conv3x3_bias_relu_plain``, ``conv3x3_same_plain`` and
  ``conv3x3_dgrad_plain``, nine shifted-slice products accumulated in
  float32, the arithmetic of the Pallas kernel's per-row im2col GEMMs.
- Wrappers: ``conv3x3_bias_relu`` and ``conv3x3_same``, each a
  ``torch.autograd.Function`` whose backward runs ``conv3x3_dgrad``, and
  ``conv3x3_dgrad``. A CPU tensor takes the plain versions; a CUDA tensor
  launches the kernel or raises on what the kernel does not take.
  ``conv3x3_bias_relu.launches``, ``conv3x3_same.launches`` and
  ``conv3x3_dgrad.launches`` count kernel launches and nothing else.

Weights are OIHW (``nn.Conv2d``'s layout). ``pack_conv3x3_weight`` puts them
in the kernel's layout. With grad mode off (predict, eval) the wrappers pack
a weight once per parameter version and keep the packed copy, and the
float32 bias where there is one, until the parameter is updated in place,
given a new storage, or freed; with grad on (training) and in dgrad they
pack on every call (``_packed_params``, which also states what the cache
cannot see).
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.ops import _build

__all__ = ["conv3x3_bias_relu", "conv3x3_bias_relu_plain", "conv3x3_dgrad", "conv3x3_dgrad_plain",
           "conv3x3_path", "conv3x3_same", "conv3x3_same_plain", "pack_conv3x3_weight"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
CHUNK = 64  # input channels per halo stage of the tensor-core path


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be NCHW, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3):
        raise ValueError(f"conv3x3: needs a ({c}, {c}, 3, 3) weight for {c} channels, "
                         f"got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"conv3x3: needs a ({c},) bias for {c} channels, got {tuple(bias.shape)}")


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


# (id weight, id bias or None, dtype) -> ((ptr, version) of the weight and
# the bias, packed weight, f32 bias or None). An entry goes when its weight
# or bias is freed (``weakref.finalize``), so a later tensor with a reused
# id never sees it, and it serves only at the pointers and versions it was
# made at: an in-place update (``_version``) or a new storage (``p.data =
# t``) repacks. ``conv3x3_same`` keeps weight-only entries (no bias).
_packed: dict[tuple, tuple] = {}


def _version(t: torch.Tensor) -> int | None:
    return None if t.is_inference() else t._version  # inference tensors keep no counter


def _pack(weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype):
    b = None if bias is None else bias.detach().float().contiguous()
    return pack_conv3x3_weight(weight, dtype), b


def _packed_params(weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype):
    """The packed weight and f32 bias (None without one), cached only while grad mode is off.

    With grad on (training) the weights change every step, so each call
    packs. Grad off (``no_grad``, ``inference_mode``: predict, eval) caches
    one packing per parameter version. An update made through ``p.data``
    (``p.data.mul_(...)``) bypasses the version counter, as it bypasses
    autograd, and is not seen there: update parameters in place under
    ``torch.no_grad()`` instead, or assign a new tensor.
    """
    tensors = (weight,) if bias is None else (weight, bias)
    versions = [_version(t) for t in tensors]
    if torch.is_grad_enabled() or None in versions:
        return _pack(weight, bias, dtype)
    key = (id(weight), None if bias is None else id(bias), dtype)
    state = tuple((t.data_ptr(), v) for t, v in zip(tensors, versions))
    hit = _packed.get(key)
    if hit is not None and hit[0] == state:
        return hit[1], hit[2]
    if hit is None:
        for t in tensors:
            weakref.finalize(t, _packed.pop, key, None)
    packed, b = _pack(weight, bias, dtype)
    _packed[key] = (state, packed, b)
    return packed, b


def _conv3x3_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv as nine shifted-slice products, weights rounded to ``x.dtype``, in f32."""
    n, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = weight.to(x.dtype).float()
    acc = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            acc += torch.einsum(
                "nihw,oi->nohw", xp[:, :, ky : ky + h, kx : kx + w], wf[:, :, ky, kx]
            )
    return acc


def conv3x3_bias_relu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) as nine shifted-slice products.

    The weights are rounded to ``x.dtype`` (as the kernel reads them), then
    everything is accumulated in float32 and the result cast to ``x.dtype``.
    """
    _check_shapes(x, weight, bias)
    y = torch.relu(_conv3x3_f32(x, weight) + bias.float()[None, :, None, None])
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def conv3x3_same_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv3x3_same(x, weight), no bias, as nine shifted-slice products.

    The Pallas kernel's own function. The weights are rounded to ``x.dtype``
    (as the kernel reads them), everything is accumulated in float32 and the
    result cast to ``x.dtype``, in ``channels_last`` memory.
    """
    _check_shapes(x, weight, None)
    return _conv3x3_f32(x, weight).to(x.dtype).contiguous(memory_format=torch.channels_last)


def _dgrad_weight(weight: torch.Tensor) -> torch.Tensor:
    """W flipped in space and transposed in channels: dgrad's conv weight."""
    return weight.detach().flip(2, 3).transpose(0, 1)


def conv3x3_dgrad_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx of conv3x3_same(x, weight) from the output's gradient ``g``, as nine products.

    The same conv of ``g`` with the weights flipped in space and transposed
    in channels, rounded to ``g.dtype``, accumulated in float32, cast to
    ``g.dtype`` (the kernel's arithmetic).
    """
    _check_shapes(g, weight, None)
    dx = _conv3x3_f32(g, _dgrad_weight(weight))
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def _launch(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor | None,
            what: str) -> torch.Tensor:
    """The kernel on ``x`` with packed weights; bias and ReLU fused when ``bias`` is given."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: needs float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: the CUDA kernel needs channels_last memory")
    if packed.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"{what}: x, weight and bias must be on one device")
    n, c, h, w = x.shape
    path = conv3x3_path(c, x.dtype)
    if path != "fma" and x.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: the tensor-core path needs a 16-byte aligned input (TMA)")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    b = 0 if bias is None else bias.data_ptr()
    fused = int(bias is not None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if path == "fma":
            fn = _build.load("conv3x3_same", "conv3x3_fma_launch", _FMA_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b, out.data_ptr(), n, h, w, c,
                      _DTYPE_CODES[x.dtype], fused, stream)
        else:
            fn = _build.load("conv3x3_same", "conv3x3_wgmma_launch", _WGMMA_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b, out.data_ptr(), n, h, w, c, fused,
                      stream)
    _build.check(code, what)
    return out


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             cache: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, weight, bias)
    _check_shapes(x, weight, bias)
    packed, b = _packed_params(weight, bias, x.dtype) if cache else _pack(weight, bias, x.dtype)
    out = _launch(x, packed, b, "conv3x3")
    conv3x3_bias_relu.launches += 1
    return out


def conv3x3_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx of conv3x3_same(x, weight) from the output's gradient ``g`` (NCHW).

    A CPU tensor takes ``conv3x3_dgrad_plain``; a CUDA tensor (channels_last)
    runs the conv kernel on ``g`` with the flipped, transposed weights
    (packed anew on every call) and its epilogue's bias and ReLU off.
    """
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, weight)
    _check_shapes(g, weight, None)
    dx = _launch(g, pack_conv3x3_weight(_dgrad_weight(weight), g.dtype), None, "conv3x3_dgrad")
    conv3x3_dgrad.launches += 1
    return dx


conv3x3_dgrad.launches = 0


class _Conv3x3BiasRelu(torch.autograd.Function):
    """relu(conv(x, W) + b) with the kernels forward and (dgrad) backward.

    Backward of the fused op: g_pre = g * (y > 0) with y the saved output;
    dx = dgrad(g_pre) through the conv kernel; db = sum of g_pre; dW by
    ``torch.nn.grad.conv2d_weight`` (cuDNN on the card), as the JAX package
    left wgrad to XLA. dW and db come back in the parameters' dtype.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, cache: bool):
        y = _forward(x, weight, bias, cache)
        if not cache:  # grad mode on: a backward may follow
            ctx.save_for_backward(x, weight, y)
            ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, y = ctx.saved_tensors
        g_pre = torch.empty_like(y, memory_format=torch.channels_last)
        torch.ops.aten.threshold_backward.grad_input(g, y, 0, grad_input=g_pre)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad(g_pre, weight).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, g_pre.to(x.dtype), padding=1)
            dw = dw.to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = g_pre.sum(dim=(0, 2, 3), dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv3x3_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) for an NCHW tensor (channels_last on the card).

    Differentiable in x, weight and bias. With grad mode off the packed
    weights come from the per-version cache; with it on (training) every
    call packs what the weight holds now.
    """
    return _Conv3x3BiasRelu.apply(x, weight, bias, not torch.is_grad_enabled())


conv3x3_bias_relu.launches = 0


def _same_forward(x: torch.Tensor, weight: torch.Tensor, cache: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, weight)
    _check_shapes(x, weight, None)
    packed, _ = _packed_params(weight, None, x.dtype) if cache else _pack(weight, None, x.dtype)
    out = _launch(x, packed, None, "conv3x3_same")
    conv3x3_same.launches += 1
    return out


class _Conv3x3Same(torch.autograd.Function):
    """conv(x, W), no bias, with the kernel forward (epilogue off) and dgrad backward.

    Backward: dx = dgrad(g) through the conv kernel; dW by
    ``torch.nn.grad.conv2d_weight`` (cuDNN on the card), as the JAX package
    left wgrad to XLA. There is no ReLU mask: BN and ReLU follow as stock
    ops. On the card ``g`` (BN's input gradient) is made ``channels_last``
    if it is not, which the kernel reads.
    """

    @staticmethod
    def forward(ctx, x, weight, cache: bool):
        y = _same_forward(x, weight, cache)
        if not cache:  # grad mode on: a backward may follow
            ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad(g, weight)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, padding=1).to(weight.dtype)
        return dx, dw, None


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv3x3_same(x, weight), no bias, for an NCHW tensor (channels_last on the card).

    Differentiable in x and weight. With grad mode off the packed weights
    come from the per-version cache; with it on (training) every call packs
    what the weight holds now.
    """
    return _Conv3x3Same.apply(x, weight, not torch.is_grad_enabled())


conv3x3_same.launches = 0
