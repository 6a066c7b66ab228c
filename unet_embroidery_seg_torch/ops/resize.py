"""Resize and pooling primitives (port of ``unet_embroidery_seg_tpu/ops/resize.py``).

The JAX ``max_pool`` has no counterpart here: the stock ``nn.MaxPool2d`` has
the semantics it reproduces. ``adaptive_avg_pool_1x1`` is multitask_unet's
global average pool. ``center_pad_to`` and ``resize_bilinear`` run
only where an odd map makes a decoder stage's sizes differ from its skip's
(never at 480^2 or 512^2, whose maps halve evenly down to 30^2 and 32^2), so
they are plain torch ops, not kernels.

The 1-D interpolation tables are computed in float64 on the host exactly as
the JAX package computes them, so the weights the CUDA upsample kernel reads
are the JAX float32 weights bit for bit; the backward kernel's inverse
tables are entries of the same matrices. Two conventions, as in the
reference:

  - ``align_corners=False`` (``nn.Upsample(mode="bilinear")``): half-pixel
    centres;
  - ``align_corners=True`` (``nn.UpsamplingBilinear2d``): the unet_resnet50
    decoder's convention.

The weights stay float32 under AMP too, where JAX's bf16 ``upsample2x`` and
``resize_bilinear`` cast the matrices to bf16 (``ops/resize.py:62,102-103``
there). That is JAX's choice of one MXU pass, a constant and not a
parameter; the reference torch code interpolates with exact weights, as the
port does. With ``align_corners=False`` the weights (0.25, 0.75) are exact
in bf16, so unet_plain, attention_unet and dualdense_unet see no difference;
with ``align_corners=True`` (unet_resnet50) rounding them moves a bf16
output by at most one bf16 ulp at its largest value
(``tests/test_torch_amp.py`` pins both).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _linear_coords(in_size: int, out_size: int, align_corners: bool):
    """(idx0, idx1, w1) tables for 1-D linear interpolation (float64 maths).

    Cached per size: the arrays are shared, so callers must not write to them.
    """
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    idx0 = np.floor(src).astype(np.int32)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    w1 = (src - idx0).astype(np.float32)
    for a in (idx0, idx1, w1):
        a.setflags(write=False)
    return idx0, idx1, w1


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) linear-interpolation matrix, 2 nonzeros per row (cached, read-only)."""
    idx0, idx1, w1 = _linear_coords(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    m[rows, idx0] += 1.0 - w1
    m[rows, idx1] += w1
    m.setflags(write=False)
    return m


Band = tuple[int, int, int]  # (H, r0, r1): the image's rows, the band's own rows [r0, r1)


def band_input_rows(band: Band) -> tuple[int, int]:
    """(first image row, rows) of a band's input: its rows and one more each side inside the image.

    The rows a 2x upsample of the band's outputs [2 r0, 2 r1) reads, in
    both conventions: input rows r0 - 1 to r1, clipped to the image.
    """
    h, r0, r1 = band
    if not 0 <= r0 < r1 <= h:
        raise ValueError(f"upsample2x: band rows [{r0}, {r1}) of an image of {h}")
    first = max(r0 - 1, 0)
    return first, min(r1 + 1, h) - first


@lru_cache(maxsize=None)
def band_matrix(band: Band, align_corners: bool) -> np.ndarray:
    """(2 (r1 - r0), band input rows) rows of a 2x resize's matrix for a band (read-only).

    The whole image's matrix, its rows for the band's outputs and its
    columns for the band's input rows (``band_input_rows``); raises if any
    of those outputs reads a row outside them.
    """
    h, r0, r1 = band
    first, rows = band_input_rows(band)
    m = _interp_matrix(h, 2 * h, align_corners)[2 * r0 : 2 * r1]
    if m[:, :first].any() or m[:, first + rows :].any():
        raise ValueError(f"upsample2x: band {band} reads beyond its halo")
    out = np.ascontiguousarray(m[:, first : first + rows])
    out.setflags(write=False)
    return out


def row_matrix(h: int, align_corners: bool, band: Band | None) -> np.ndarray:
    """The (outputs, inputs) matrix of a 2x resize of ``h`` rows, or of a ``band`` of them."""
    return _interp_matrix(h, 2 * h, align_corners) if band is None else band_matrix(band,
                                                                                  align_corners)


def upsample2x_plain(x: torch.Tensor, align_corners: bool = False,
                     band: Band | None = None) -> torch.Tensor:
    """2x bilinear upsample of NCHW as the two interpolation-matrix contractions.

    Maths in float32 whatever the input type (the CUDA kernel's convention),
    autocast off; the result is cast back to ``x.dtype`` in ``channels_last``
    memory. ``band`` (H, r0, r1): x is the band's input rows
    (``band_input_rows``) of an image of H rows, and the result is its
    output rows [2 r0, 2 r1), as the whole image's upsample has them.
    """
    h, w = x.shape[-2], x.shape[-1]
    if band is not None and band_input_rows(band)[1] != h:
        raise ValueError(f"upsample2x: band {band} takes {band_input_rows(band)[1]} rows, "
                         f"got {h}")
    mh = torch.tensor(row_matrix(h, align_corners, band), device=x.device)
    mw = torch.tensor(_interp_matrix(w, 2 * w, align_corners), device=x.device)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("oh,nchw->ncow", mh, x.float())
        y = torch.einsum("pw,ncow->ncop", mw, y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def upsample2x_backward_plain(g: torch.Tensor, align_corners: bool = False,
                              band: Band | None = None) -> torch.Tensor:
    """dx of ``upsample2x_plain`` from the output's gradient: the transposed contractions.

    ``g`` is (N, C, 2H, 2W); maths in float32 (autocast off), the result cast back to
    ``g.dtype`` in ``channels_last`` memory (the backward kernel's convention).
    ``band``: g is the band's output rows, dx its input rows (halo rows included).
    """
    h, w = g.shape[-2] // 2, g.shape[-1] // 2
    if band is not None:
        if 2 * (band[2] - band[1]) != g.shape[-2]:
            raise ValueError(f"upsample2x_backward: band {band} has {2 * (band[2] - band[1])} "
                             f"output rows, got {g.shape[-2]}")
        h = band_input_rows(band)[1]
    mh = torch.tensor(row_matrix(h, align_corners, band), device=g.device)
    mw = torch.tensor(_interp_matrix(w, 2 * w, align_corners), device=g.device)
    with torch.autocast(g.device.type, enabled=False):
        dx = torch.einsum("oh,ncop->nchp", mh, g.float())
        dx = torch.einsum("pw,nchp->nchw", mw, dx)
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW to ``out_hw`` as interpolation-matrix contractions.

    The JAX package's ``resize_bilinear``: one contraction per axis whose
    size changes (an axis of equal size is left alone), with the matrices
    of ``_interp_matrix``. Maths in float32 (autocast off), the result cast back to
    ``x.dtype`` in ``channels_last`` memory. Its gradient is the transposed
    contractions, deterministic like the upsample kernel's (where
    ``F.interpolate``'s backward adds with atomics on the card).
    """
    h, w = x.shape[-2], x.shape[-1]
    y = x.float()
    with torch.autocast(x.device.type, enabled=False):
        if out_hw[0] != h:
            mh = torch.tensor(_interp_matrix(h, out_hw[0], align_corners), device=x.device)
            y = torch.einsum("oh,nchw->ncow", mh, y)
        if out_hw[1] != w:
            mw = torch.tensor(_interp_matrix(w, out_hw[1], align_corners), device=x.device)
            y = torch.einsum("pw,nchw->nchp", mw, y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def center_pad_to(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Symmetric zero pad of NCHW to ``target_hw`` (the extra row or column at the end).

    The JAX package's ``center_pad_to`` (unet_plain's decoder); the result
    is in ``channels_last`` memory.
    """
    dh, dw = target_hw[0] - x.shape[-2], target_hw[1] - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    y = torch.nn.functional.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return y.contiguous(memory_format=torch.channels_last)


def adaptive_avg_pool_1x1(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NCHW -> NC (``AdaptiveAvgPool2d(1)`` + Flatten).

    The JAX package's ``jnp.mean`` over H and W: the sum in float32 whatever
    the input type, the result in the input's type (bf16 under autocast).
    """
    return x.float().mean(dim=(2, 3)).to(x.dtype)
