"""Resize and pooling primitives (port of ``unet_embroidery_seg_tpu/ops/resize.py``).

The JAX ``max_pool`` has no counterpart here: the stock ``nn.MaxPool2d`` has
the semantics it reproduces. ``center_pad_to`` and ``resize_bilinear`` run
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


def upsample2x_plain(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """2x bilinear upsample of NCHW as the two interpolation-matrix contractions.

    Maths in float32 whatever the input type (the CUDA kernel's convention);
    the result is cast back to ``x.dtype`` in ``channels_last`` memory.
    """
    h, w = x.shape[-2], x.shape[-1]
    mh = torch.tensor(_interp_matrix(h, 2 * h, align_corners), device=x.device)
    mw = torch.tensor(_interp_matrix(w, 2 * w, align_corners), device=x.device)
    y = torch.einsum("oh,nchw->ncow", mh, x.float())
    y = torch.einsum("pw,ncow->ncop", mw, y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def upsample2x_backward_plain(g: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """dx of ``upsample2x_plain`` from the output's gradient: the transposed contractions.

    ``g`` is (N, C, 2H, 2W); maths in float32, the result cast back to
    ``g.dtype`` in ``channels_last`` memory (the backward kernel's convention).
    """
    h, w = g.shape[-2] // 2, g.shape[-1] // 2
    mh = torch.tensor(_interp_matrix(h, 2 * h, align_corners), device=g.device)
    mw = torch.tensor(_interp_matrix(w, 2 * w, align_corners), device=g.device)
    dx = torch.einsum("oh,ncop->nchp", mh, g.float())
    dx = torch.einsum("pw,nchp->nchw", mw, dx)
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW to ``out_hw`` as interpolation-matrix contractions.

    The JAX package's ``resize_bilinear``: one contraction per axis whose
    size changes (an axis of equal size is left alone), with the matrices
    of ``_interp_matrix``. Maths in float32, the result cast back to
    ``x.dtype`` in ``channels_last`` memory. Its gradient is the transposed
    contractions, deterministic like the upsample kernel's (where
    ``F.interpolate``'s backward adds with atomics on the card).
    """
    h, w = x.shape[-2], x.shape[-1]
    y = x.float()
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
