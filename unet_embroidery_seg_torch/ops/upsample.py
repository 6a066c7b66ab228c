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
- Backward kernel: ``csrc/upsample2x_bwd.cu``. Bound by bytes: it reads
  the output's gradient once and writes dx once. A block owns a band of
  input rows, a strip of input columns and a channel chunk, and streams the
  output rows the band reads through a ring in shared memory (``cp.async``);
  each staged row is reduced to the strip's columns (column pass), then
  added into the two input rows it reads, which roll down the band (row
  pass). The tables come from ``backward_taps``, ``backward_reach`` and
  ``inverse_taps``; no atomics, so the gradient is deterministic.
- Plain versions: ``ops/resize.py:upsample2x_plain`` and
  ``upsample2x_backward_plain``, the interpolation-matrix contractions (the
  backward's are the transposed ones) in float32.
- Operators (``ops/library.py``): ``unet_seg::upsample2x`` and
  ``unet_seg::upsample2x_backward`` (``upsample2x_op``,
  ``upsample2x_backward_op``): on a CUDA tensor the kernel, on a CPU tensor
  the plain version, and a fake implementation for tracing.
- Band mode (the mesh's ``space`` axis, ``parallel/halo.py``): every
  form takes ``band=(H, r0, r1)``: the input is rows [r0, r1) of an image
  of H rows with one exchanged row on each side inside the image
  (``ops/resize.band_input_rows``), the output its rows [2 r0, 2 r1), the
  unsplit upsample's rows. The kernels take the output height as an
  argument; the row tables are the whole image's for the band's rows,
  shifted to its first input row (``band_coords``), so each tile's check
  holds for the band. The backward gives the band's share of each input
  row's gradient, the halo rows' too, which the exchange's backward sends
  to their owners: no atomics, still deterministic. ``.halo_launches``
  counts the band launches (in ``.launches`` too).
- Wrappers: ``upsample2x`` (a ``torch.autograd.Function`` over the forward
  operator whose backward is ``upsample2x_backward``, the backward
  operator). A CPU tensor takes the plain versions; a CUDA tensor launches
  the kernels or raises on what they do not take. ``upsample2x.launches``
  and ``upsample2x_backward.launches`` count kernel launches and nothing
  else (not calls traced with fake tensors).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.ops import _build
from unet_embroidery_seg_torch.ops.library import as_kernel_layout, empty_kernel_output
from unet_embroidery_seg_torch.ops.resize import (
    Band,
    _linear_coords,
    band_input_rows,
    row_matrix,
    upsample2x_backward_plain,
    upsample2x_plain,
)

__all__ = ["upsample2x", "upsample2x_backward", "upsample2x_backward_plain", "upsample2x_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


# Output rows and columns of the kernel's tiles (csrc/upsample2x.cu: TH, TW).
TILE_SIZES = (8, 16, 32)


def tile_input_span(idx0: np.ndarray, idx1: np.ndarray, tile: int) -> int:
    """The most input rows (or columns) one ``tile`` of outputs reads.

    With ``backward_reach``'s (first, last) in place of the forward's taps:
    the most outputs one ``tile`` of inputs is read by.
    """
    starts = np.arange(0, len(idx0), tile)
    ends = np.minimum(starts + tile, len(idx0)) - 1
    return int((idx1[ends] - idx0[starts]).max()) + 1


def band_coords(size: int, align_corners: bool, band: Band | None = None):
    """(idx0, idx1, w1) of a 2x resize of ``size``, or of a ``band`` of it (``size`` its rows).

    For a band: the whole image's tables at its outputs [2 r0, 2 r1), the
    indices counted from its first input row.
    """
    if band is None:
        return _linear_coords(size, 2 * size, align_corners)
    h, r0, r1 = band
    first, rows = band_input_rows(band)
    if rows != size:
        raise ValueError(f"upsample2x: band {band} takes {rows} rows, got {size}")
    idx0, idx1, w1 = _linear_coords(h, 2 * h, align_corners)
    out = slice(2 * r0, 2 * r1)
    return idx0[out] - first, idx1[out] - first, w1[out]


@lru_cache(maxsize=None)
def _device_tables(size: int, align_corners: bool, device: torch.device,
                   band: Band | None = None):
    """([idx0, idx1] int32, w1 float32) on ``device`` for a 2x resize of ``size`` (or its band).

    Checks that every kernel tile's taps fit its shared-memory staging area
    (tile/2 + 2 input rows and columns), which holds for any 2x resize and
    any band of one.
    """
    idx0, idx1, w1 = band_coords(size, align_corners, band)
    for tile in TILE_SIZES:
        if tile_input_span(idx0, idx1, tile) > tile // 2 + 2:
            raise ValueError(f"upsample2x: a {tile}-output tile of size {size} reads too many inputs")
    idx = torch.tensor(np.concatenate([idx0, idx1]), dtype=torch.int32, device=device)
    return idx, torch.tensor(w1, dtype=torch.float32, device=device)


def inverse_taps(size: int, align_corners: bool,
                 band: Band | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(index int32 [size, K], weight float32 [size, K]) of a 2x resize's transpose.

    Row i lists the outputs whose interpolation reads input i and the weight
    it gets there, which is the interpolation matrix's entry, so the
    backward kernel sums exactly what the transposed contraction sums.
    Padded with weight-0 entries (index 0) to K, the most any input has (4
    for every 2x resize). ``band``: of the band's matrix (``size`` its input rows).
    """
    m = row_matrix(size, align_corners, band)
    cols = [np.flatnonzero(m[:, i]) for i in range(size)]
    k = max(len(c) for c in cols)
    idx = np.zeros((size, k), np.int32)
    wgt = np.zeros((size, k), np.float32)
    for i, c in enumerate(cols):
        idx[i, : len(c)] = c
        wgt[i, : len(c)] = m[c, i]
    return idx, wgt


# Input rows per band and input columns per strip of the backward kernel's
# blocks (csrc/upsample2x_bwd.cu: band, TW); each reads at most 2 T + 2
# outputs, the kernel's ring and table sizes.
BWD_BANDS = (2, 4, 8, 16)
BWD_STRIPS = (16, 32)
BWD_TAPS = 4  # inverse taps per input (csrc/upsample2x_bwd.cu: TAPS)


def backward_taps(size: int, align_corners: bool, band: Band | None = None):
    """Per-output taps of a 2x resize, for the backward kernel: ``(i0, i1, w0, w1)``.

    Output o reads inputs ``i0[o]`` and ``i1[o]`` (equal at a clipped edge)
    with the interpolation matrix's entries ``w0[o] = M[o, i0]`` and
    ``w1[o] = M[o, i1]``, or 0 where ``i1 == i0`` (one entry, ``M[o, i0]``).
    ``band``: the band's outputs and its input rows (``size`` of them).
    """
    i0, i1, _ = band_coords(size, align_corners, band)
    m = row_matrix(size, align_corners, band)
    o = np.arange(len(i0))
    w1 = np.where(i1 != i0, m[o, i1], np.float32(0.0)).astype(np.float32)
    return i0, i1, m[o, i0], w1


def backward_reach(size: int, align_corners: bool,
                   band: Band | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(first, last) int32: input i of a 2x resize is read by outputs first[i]..last[i], no others.

    Both index tables are non-decreasing and step by at most one, so the
    first output with ``i1 >= i`` and the last with ``i0 <= i`` read i.
    ``band``: of the band's outputs, for its input rows (``size`` of them).
    """
    i0, i1, _ = band_coords(size, align_corners, band)
    inputs = np.arange(size)
    first = np.searchsorted(i1, inputs, side="left")
    last = np.searchsorted(i0, inputs, side="right") - 1
    return first.astype(np.int32), last.astype(np.int32)


@lru_cache(maxsize=None)
def _backward_tables(size: int, align_corners: bool, device: torch.device,
                     band: Band | None = None):
    """(idx int32, wgt float32) on ``device``, laid out as csrc/upsample2x_bwd.cu reads them.

    idx = [i0, first, last, inverse index (size x 4)], wgt = [w0, w1,
    inverse weight (size x 4)]. Checks what the kernel relies on: i0 steps
    by at most one from output to output, every band and strip reads at most
    2 T + 2 outputs, and no input has more than 4 nonzero taps. ``band``:
    the tables of a band (``size`` its input rows).
    """
    i0, _, w0, w1 = backward_taps(size, align_corners, band)
    first, last = backward_reach(size, align_corners, band)
    inv_idx, inv_w = inverse_taps(size, align_corners, band)
    if np.diff(i0).max(initial=0) > 1 or inv_idx.shape[1] > BWD_TAPS:
        raise ValueError(f"upsample2x_backward: unexpected taps for size {size}")
    for t in BWD_BANDS + BWD_STRIPS:
        if tile_input_span(first, last, t) > 2 * t + 2:
            raise ValueError(f"upsample2x_backward: a {t}-input band of size {size} "
                             "reads too many outputs")
    pad = ((0, 0), (0, BWD_TAPS - inv_idx.shape[1]))
    idx = np.concatenate([i0, first, last, np.pad(inv_idx, pad).ravel()]).astype(np.int32)
    wgt = np.concatenate([w0, w1, np.pad(inv_w, pad).ravel()]).astype(np.float32)
    return torch.tensor(idx, device=device), torch.tensor(wgt, device=device)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: needs a 4-D float32/bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _band(band: list[int] | None) -> Band | None:
    return None if band is None else tuple(int(b) for b in band)


def _out_rows(h: int, band: Band | None) -> int:
    """Output rows of a forward on ``h`` input rows: 2h, or the band's 2 (r1 - r0)."""
    if band is None:
        return 2 * h
    if band_input_rows(band)[1] != h:
        raise ValueError(f"upsample2x: band {band} takes {band_input_rows(band)[1]} rows, "
                         f"got {h}")
    return 2 * (band[2] - band[1])


def _in_rows(oh: int, band: Band | None) -> int:
    """Input rows of a backward from ``oh`` output rows: oh / 2, or the band's input rows."""
    if band is None:
        return oh // 2
    if 2 * (band[2] - band[1]) != oh:
        raise ValueError(f"upsample2x_backward: band {band} has {2 * (band[2] - band[1])} "
                         f"output rows, got {oh}")
    return band_input_rows(band)[1]


def _count(wrapper, band: Band | None) -> None:
    wrapper.launches += 1
    if band is not None:
        wrapper.halo_launches += 1


def _upsample2x_cuda(x: torch.Tensor, align_corners: bool,
                     band: list[int] | None = None) -> torch.Tensor:
    """``unet_seg::upsample2x`` on a CUDA tensor: the forward kernel (channels_last in and out).

    ``band`` (H, r0, r1): x is a band's input rows, the output its rows.
    """
    _check_cuda(x, "upsample2x")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("upsample2x: the CUDA kernel needs channels_last memory")
    band = _band(band)
    n, c, h, w = x.shape
    oh = _out_rows(h, band)
    out = empty_kernel_output((n, c, oh, 2 * w), x)
    if out.numel() == 0:
        return out
    rows_idx, rows_w = _device_tables(h, align_corners, x.device, band)
    cols_idx, cols_w = _device_tables(w, align_corners, x.device)
    fn = _build.load("upsample2x", "upsample2x_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), rows_idx.data_ptr(), rows_w.data_ptr(),
                  cols_idx.data_ptr(), cols_w.data_ptr(), n, h, w, c, oh,
                  _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "upsample2x")
    _count(upsample2x, band)
    return out


upsample2x_op = torch.library.custom_op(
    "unet_seg::upsample2x", _upsample2x_cuda, mutates_args=(), device_types="cuda")


@upsample2x_op.register_kernel("cpu")
def _(x: torch.Tensor, align_corners: bool, band: list[int] | None = None) -> torch.Tensor:
    return as_kernel_layout(upsample2x_plain(x, align_corners, _band(band)))


@upsample2x_op.register_fake
def _(x: torch.Tensor, align_corners: bool, band: list[int] | None = None) -> torch.Tensor:
    n, c, h, w = x.shape
    return empty_kernel_output((n, c, _out_rows(h, _band(band)), 2 * w), x)


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


def _upsample2x_backward_cuda(g: torch.Tensor, align_corners: bool,
                              band: list[int] | None = None) -> torch.Tensor:
    """``unet_seg::upsample2x_backward`` on a CUDA tensor: the backward kernel."""
    _check_cuda(g, "upsample2x_backward")
    band = _band(band)
    n, c, oh, ow = g.shape
    if oh % 2 or ow % 2:
        raise ValueError(f"upsample2x_backward: needs an even output size, got {oh} x {ow}")
    h, w = _in_rows(oh, band), ow // 2
    dx = empty_kernel_output((n, c, h, w), g)
    if dx.numel() == 0:
        return dx
    strides = _pixel_strides(g)
    if strides is None:
        g = g.contiguous(memory_format=torch.channels_last)
        strides = _pixel_strides(g)
    g_img, g_pix = strides
    rows_idx, rows_w = _backward_tables(h, align_corners, g.device, band)
    cols_idx, cols_w = _backward_tables(w, align_corners, g.device)
    fn = _build.load("upsample2x_bwd", "upsample2x_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(g.device):
        code = fn(g.data_ptr(), dx.data_ptr(), rows_idx.data_ptr(), rows_w.data_ptr(),
                  cols_idx.data_ptr(), cols_w.data_ptr(), n, h, w, c, oh, g_img, g_pix,
                  _DTYPE_CODES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(code, "upsample2x_backward")
    _count(upsample2x_backward, band)
    return dx


upsample2x_backward_op = torch.library.custom_op(
    "unet_seg::upsample2x_backward", _upsample2x_backward_cuda, mutates_args=(),
    device_types="cuda")


@upsample2x_backward_op.register_kernel("cpu")
def _(g: torch.Tensor, align_corners: bool, band: list[int] | None = None) -> torch.Tensor:
    return as_kernel_layout(upsample2x_backward_plain(g, align_corners, _band(band)))


@upsample2x_backward_op.register_fake
def _(g: torch.Tensor, align_corners: bool, band: list[int] | None = None) -> torch.Tensor:
    n, c, oh, ow = g.shape
    return empty_kernel_output((n, c, _in_rows(oh, _band(band)), ow // 2), g)


def upsample2x_backward(g: torch.Tensor, align_corners: bool = False,
                        band: Band | None = None) -> torch.Tensor:
    """dx of ``upsample2x`` from the output's gradient ``g`` (N, C, 2H, 2W).

    On the card ``g`` may be any channels_last-like view, such as the
    channel slice of a ``torch.cat`` gradient, which the kernel reads in
    place; any other layout (plain NCHW) is first copied to channels_last
    (one read and write of ``g``). dx comes back channels_last in ``g``'s
    dtype. ``band``: g is a band's output rows, dx its input rows.
    """
    return upsample2x_backward_op(g, align_corners, None if band is None else list(band))


upsample2x_backward.launches = 0
upsample2x_backward.halo_launches = 0


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, align_corners: bool, band: Band | None) -> torch.Tensor:
        ctx.align_corners, ctx.band = align_corners, band
        return upsample2x_op(x, align_corners, None if band is None else list(band))

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        return upsample2x_backward(g, ctx.align_corners, ctx.band), None, None


def upsample2x(x: torch.Tensor, align_corners: bool = False,
               band: Band | None = None) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor (``channels_last`` on the card), differentiable.

    ``band`` (H, r0, r1): x is a band's input rows (its own and one
    exchanged row each side inside the image), the output the band's rows.
    """
    return _Upsample2x.apply(x, align_corners, band)


upsample2x.launches = 0
upsample2x.halo_launches = 0
