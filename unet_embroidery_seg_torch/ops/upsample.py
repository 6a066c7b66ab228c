"""2x bilinear upsample: the hand-written CUDA kernels, their plain versions, their wrappers.

Replaces ``docs/negative-results/pallas_upsample.py:upsample2x_pallas`` (the
Pallas TPU kernel) and its custom VJP at the five unet_resnet50 decoder
sites, which the JAX package computes with ``ops/resize.py:upsample2x`` (an
einsum).

- Forward kernel: ``csrc/upsample2x.cu``. Bound by bytes on the H100: it
  reads each input byte about once and writes each output byte once, ~176
  us per forward at 480^2, batch 8, bf16 (3.35 TB/s). A block stages the
  input pixels of an 8 x 32 output tile and a 128-byte channel chunk (8 x
  16 and 256 bytes where C is wide) in shared memory once, then writes the
  tile 16 bytes a thread; the tap tables come from the host, so any H, W, C
  works.
- Backward kernel: ``csrc/upsample2x_bwd.cu``, gather-style: each input
  pixel sums its own output taps, read through the inverse tables
  (``_inverse_tables``), with no atomics, so the gradient is deterministic.
  Bound by bytes: it reads the output's gradient once and writes dx once.
- Plain versions: ``ops/resize.py:upsample2x_plain`` and
  ``upsample2x_backward_plain``, the interpolation-matrix contractions (the
  backward's are the transposed ones) in float32.
- Wrappers: ``upsample2x`` (a ``torch.autograd.Function`` whose backward is
  ``upsample2x_backward``). A CPU tensor takes the plain versions; a CUDA
  tensor launches the kernels or raises on what they do not take.
  ``upsample2x.launches`` and ``upsample2x_backward.launches`` count kernel
  launches and nothing else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.ops import _build
from unet_embroidery_seg_torch.ops.resize import (
    _interp_matrix,
    _linear_coords,
    upsample2x_backward_plain,
    upsample2x_plain,
)

__all__ = ["upsample2x", "upsample2x_backward", "upsample2x_backward_plain", "upsample2x_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


# Output rows and columns of the kernel's tiles (csrc/upsample2x.cu: TH, TW).
TILE_SIZES = (8, 16, 32)


def tile_input_span(idx0: np.ndarray, idx1: np.ndarray, tile: int) -> int:
    """The most input rows (or columns) one ``tile`` of outputs reads."""
    starts = np.arange(0, len(idx0), tile)
    ends = np.minimum(starts + tile, len(idx0)) - 1
    return int((idx1[ends] - idx0[starts]).max()) + 1


@lru_cache(maxsize=None)
def _device_tables(size: int, align_corners: bool, device: torch.device):
    """([idx0, idx1] int32, w1 float32) on ``device`` for a 2x resize of ``size``.

    Checks that every kernel tile's taps fit its shared-memory staging area
    (tile/2 + 2 input rows and columns), which holds for any 2x resize.
    """
    idx0, idx1, w1 = _linear_coords(size, 2 * size, align_corners)
    for tile in TILE_SIZES:
        if tile_input_span(idx0, idx1, tile) > tile // 2 + 2:
            raise ValueError(f"upsample2x: a {tile}-output tile of size {size} reads too many inputs")
    idx = torch.tensor(np.concatenate([idx0, idx1]), dtype=torch.int32, device=device)
    return idx, torch.tensor(w1, dtype=torch.float32, device=device)


def inverse_taps(size: int, align_corners: bool) -> tuple[np.ndarray, np.ndarray]:
    """(index int32 [size, K], weight float32 [size, K]) of a 2x resize's transpose.

    Row i lists the outputs whose interpolation reads input i and the weight
    it gets there, which is the interpolation matrix's entry, so the
    backward kernel sums exactly what the transposed contraction sums.
    Padded with weight-0 entries (index 0) to K, the most any input has (4
    for every 2x resize).
    """
    m = _interp_matrix(size, 2 * size, align_corners)
    cols = [np.flatnonzero(m[:, i]) for i in range(size)]
    k = max(len(c) for c in cols)
    idx = np.zeros((size, k), np.int32)
    wgt = np.zeros((size, k), np.float32)
    for i, c in enumerate(cols):
        idx[i, : len(c)] = c
        wgt[i, : len(c)] = m[c, i]
    return idx, wgt


@lru_cache(maxsize=None)
def _inverse_tables(size: int, align_corners: bool, device: torch.device):
    """``inverse_taps`` on ``device``: (index int32, weight float32, K)."""
    idx, wgt = inverse_taps(size, align_corners)
    return (torch.tensor(idx, device=device), torch.tensor(wgt, device=device), idx.shape[1])


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: needs a 4-D float32/bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _forward(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return upsample2x_plain(x, align_corners)
    _check_cuda(x, "upsample2x")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("upsample2x: the CUDA kernel needs channels_last memory")
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    rows_idx, rows_w = _device_tables(h, align_corners, x.device)
    cols_idx, cols_w = _device_tables(w, align_corners, x.device)
    fn = _build.load("upsample2x", "upsample2x_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), rows_idx.data_ptr(), rows_w.data_ptr(),
                  cols_idx.data_ptr(), cols_w.data_ptr(), n, h, w, c,
                  _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "upsample2x")
    upsample2x.launches += 1
    return out


def _pixel_strides(g: torch.Tensor) -> tuple[int, int] | None:
    """(image stride, pixel stride) in elements if ``g`` is channels_last-like.

    That is: channels contiguous, pixels ``pixel stride`` apart row-major,
    images ``image stride`` apart, as in a channel slice of a wider
    channels_last tensor. None otherwise.
    """
    n, c, h, w = g.shape
    s_n, s_c, s_h, s_w = g.stride()
    if (s_c == 1 or c == 1) and s_w >= c and s_h == w * s_w and (n == 1 or s_n >= h * s_h):
        return (s_n if n > 1 else h * s_h), s_w
    return None


def upsample2x_backward(g: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """dx of ``upsample2x`` from the output's gradient ``g`` (N, C, 2H, 2W).

    On the card ``g`` may be any channels_last-like view, such as the
    channel slice of a ``torch.cat`` gradient, which the kernel reads in
    place; any other layout (plain NCHW) is first copied to channels_last
    (one read and write of ``g``). dx comes back channels_last in ``g``'s
    dtype.
    """
    if g.device.type == "cpu":
        return upsample2x_backward_plain(g, align_corners)
    _check_cuda(g, "upsample2x_backward")
    n, c, oh, ow = g.shape
    if oh % 2 or ow % 2:
        raise ValueError(f"upsample2x_backward: needs an even output size, got {oh} x {ow}")
    h, w = oh // 2, ow // 2
    dx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    if dx.numel() == 0:
        return dx
    strides = _pixel_strides(g)
    if strides is None:
        g = g.contiguous(memory_format=torch.channels_last)
        strides = _pixel_strides(g)
    g_img, g_pix = strides
    rows_idx, rows_w, kr = _inverse_tables(h, align_corners, g.device)
    cols_idx, cols_w, kc = _inverse_tables(w, align_corners, g.device)
    fn = _build.load("upsample2x_bwd", "upsample2x_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(g.device):
        code = fn(g.data_ptr(), dx.data_ptr(), rows_idx.data_ptr(), rows_w.data_ptr(),
                  cols_idx.data_ptr(), cols_w.data_ptr(), n, h, w, c, kr, kc, g_img, g_pix,
                  _DTYPE_CODES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(code, "upsample2x_backward")
    upsample2x_backward.launches += 1
    return dx


upsample2x_backward.launches = 0


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, align_corners: bool) -> torch.Tensor:
        ctx.align_corners = align_corners
        return _forward(x, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        return upsample2x_backward(g, ctx.align_corners), None


def upsample2x(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor (``channels_last`` on the card), differentiable."""
    return _Upsample2x.apply(x, align_corners)


upsample2x.launches = 0
