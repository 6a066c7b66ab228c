"""2x bilinear upsample: the hand-written CUDA kernel, its plain version, its wrapper.

Replaces ``docs/negative-results/pallas_upsample.py:upsample2x_pallas`` (the
Pallas TPU kernel) at the five unet_resnet50 decoder sites, which the JAX
package computes with ``ops/resize.py:upsample2x`` (an einsum).

- Kernel: ``csrc/upsample2x.cu``. Bound by bytes on the H100: it reads each
  input byte about once and writes each output byte once, ~176 us per
  forward at 480^2, batch 8, bf16 (3.35 TB/s). One thread per output pixel
  and 16-byte channel vector; the tap tables come from the host, so any
  H, W, C works.
- Plain version: ``ops/resize.py:upsample2x_plain``, the two
  interpolation-matrix contractions in float32.
- Wrapper: ``upsample2x``. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises on what the kernel does not take.
  ``upsample2x.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from unet_embroidery_seg_torch.ops import _build
from unet_embroidery_seg_torch.ops.resize import _linear_coords, upsample2x_plain

__all__ = ["upsample2x", "upsample2x_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@lru_cache(maxsize=None)
def _device_tables(size: int, align_corners: bool, device: torch.device):
    """([idx0, idx1] int32, w1 float32) on ``device`` for a 2x resize of ``size``."""
    idx0, idx1, w1 = _linear_coords(size, 2 * size, align_corners)
    idx = torch.tensor(np.concatenate([idx0, idx1]), dtype=torch.int32, device=device)
    return idx, torch.tensor(w1, dtype=torch.float32, device=device)


def upsample2x(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor (``channels_last`` on the card)."""
    if x.device.type == "cpu":
        return upsample2x_plain(x, align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"upsample2x: needs a 4-D float32/bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
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


upsample2x.launches = 0
