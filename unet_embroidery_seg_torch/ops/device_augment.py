"""Batched training augmentation on the card (port of ``ops/device_augment.py``).

The host path augments every sample with PIL/cv2 on the CPU. This module
applies the same augmentation distribution to a batch of letterboxed uint8
canvases already on the card (``engine/resident.py``):

  host (once per run):   decode + aspect-preserving letterbox onto a fixed
                         uint8 canvas (``data/cache.py``)
  card (every batch):    aspect jitter (ratio of two U(1-j,1+j)), scale
                         U(0.25,2), h-flip p=.5, random placement, bilinear
                         (image) / nearest (mask) resample, HSV jitter
                         (hue .1, sat .7, val .3, cv2 LUT convention)

The JAX package resamples by batched matmul with dense per-sample tent and
one-hot matrices, because a gather is slow on a TPU. The same function is a
two-tap gather per axis here: bilinear reads rows ``i0 = floor(c)`` and
``i0 + 1`` (clamped) of the clipped coordinate ``c`` with the tent weights
``clip(1 - |c - i|, 0, 1)``, nearest reads ``clip(floor(c + 0.5), 0, in - 1)``.
Every other entry of JAX's matrices is 0, so both give the same sums.

Sampling is kept apart from use: ``sample_params`` draws the seven
parameter tensors from an explicit ``torch.Generator``, and
``augment_batch`` takes either the generator or those tensors. Everything
runs in float32 with autocast off, as plain PyTorch ops on the batch's
device (no hand-written kernel: the JAX module is XLA code, not Pallas).

A division by a constant is written as the product with its float32
reciprocal (``x * (1.0 / 255.0)``): XLA compiles the JAX functions' ``x /
255.0`` so, and PyTorch's CUDA division by a scalar too, so the CPU and the
card give JAX's jitted numbers. The host pipeline's numpy ``x / 255.0``
rounds to the nearest float32 and is one ulp off in places.
"""

from __future__ import annotations

import torch

INV_255, INV_60 = 1.0 / 255.0, 1.0 / 60.0

AugParams = tuple[torch.Tensor, ...]  # (ar_a, ar_b, scale, flip, place_x, place_y, hsv_r)


def sample_params(generator: torch.Generator, n: int, jitter: float = 0.3, hue: float = 0.1,
                  sat: float = 0.7, val: float = 0.3) -> AugParams:
    """Per-sample augmentation parameters drawn from ``generator``, on its device.

    (ar_a, ar_b) U(1-jitter, 1+jitter), scale U(0.25, 2), flip (bool, p=.5),
    place_x, place_y U(0, 1), hsv_r (n, 3) channel gains U(-1, 1) * (hue,
    sat, val) + 1, as the JAX package draws them.
    """
    dev = generator.device

    def u(lo=0.0, hi=1.0, shape=(n,)):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    ar_a = u(1 - jitter, 1 + jitter)
    ar_b = u(1 - jitter, 1 + jitter)
    scale = u(0.25, 2.0)
    flip = u() < 0.5
    place_x, place_y = u(), u()
    # one column per gain: a gain vector made on the card would be a copy
    # from the host, which waits for the card's queue to drain
    hsv_r = torch.stack([u(-1.0, 1.0) * g + 1.0 for g in (hue, sat, val)], dim=1)
    return ar_a, ar_b, scale, flip, place_x, place_y, hsv_r


def axis_coords(out_size: int, n_new: torch.Tensor, offset: torch.Tensor, src_lo: torch.Tensor,
                src_extent: torch.Tensor, flip: torch.Tensor | None):
    """Source coordinates for one output axis of the paste-resample.

    Output pixel p maps into the pasted rectangle [offset, offset + n_new);
    inside it the source coordinate spans [src_lo, src_lo + src_extent) by
    PIL's box convention, in JAX's operation order:
    ``(p - offset + 0.5) / max(n_new, 1)``, the flip ``1 - t``, then
    ``t * extent - 0.5 + lo``. Returns (coords (N, S), valid (N, S)).
    """
    p = torch.arange(out_size, dtype=torch.float32, device=n_new.device)[None, :]
    rel = p - offset[:, None]
    valid = (rel >= 0) & (rel < n_new[:, None])
    t = (rel + 0.5) / torch.clamp(n_new[:, None], min=1.0)
    if flip is not None:
        t = torch.where(flip[:, None], 1.0 - t, t)
    coords = t * src_extent[:, None] - 0.5 + src_lo[:, None]
    return coords, valid


def _taps(coords: torch.Tensor, in_size: int, mode: str):
    """[(index (N, S) int64, weight (N, S) or None)]: the nonzero entries of JAX's row."""
    c = torch.clamp(coords, 0.0, in_size - 1)
    if mode == "nearest":  # PIL's convention: floor(c + 0.5)
        return [(torch.clamp(torch.floor(c + 0.5), 0, in_size - 1).long(), None)]
    i0 = torch.floor(c)
    i1 = i0 + 1.0  # its weight is 0 at c == in - 1, where the index is clamped
    return [(i.clamp(max=in_size - 1).long(), torch.clamp(1.0 - torch.abs(c - i), 0.0, 1.0))
            for i in (i0, i1)]


def _resample(x: torch.Tensor, coords: torch.Tensor, mode: str, axis: int) -> torch.Tensor:
    """Resample NHWC ``x`` along H (``axis`` 1) or W (2) at per-sample (N, S) coords.

    One ``index_select`` per tap over the flattened (N * in, ...) view; the
    bilinear taps are summed ``w0 * x0 + w1 * x1``.
    """
    n, in_size = x.shape[0], x.shape[axis]
    xs = x if axis == 1 else x.transpose(1, 2)  # (N, in, other, C)
    flat = xs.reshape(n * in_size, -1)
    base = torch.arange(n, device=x.device)[:, None] * in_size
    out = None
    for idx, w in _taps(coords, in_size, mode):
        rows = flat.index_select(0, (idx + base).reshape(-1)).reshape(n, idx.shape[1], -1)
        term = rows if w is None else w[:, :, None] * rows
        out = term if out is None else out + term
    out = out.reshape(n, idx.shape[1], xs.shape[2], xs.shape[3])
    return out if axis == 1 else out.transpose(1, 2)


def rgb_to_hsv_cv(rgb: torch.Tensor):
    """cv2-convention HSV from float RGB in [0, 1]: H in [0, 180), S and V in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    # in this order, so that a tie between maxima goes to b, then g
    h = torch.where(maxc == r, bc - gc, zero)
    h = torch.where(maxc == g, 2.0 + rc - bc, h)
    h = torch.where(maxc == b, 4.0 + gc - rc, h)
    h = torch.where(delta > 0, h, zero)
    h = torch.remainder(h * 60.0, 360.0)  # jnp's float %: a floor-mod
    return h / 2.0, s * 255.0, maxc * 255.0


def hsv_to_rgb_cv(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """cv2-convention HSV -> float RGB in [0, 1]."""
    hdeg = h * 2.0
    sf = s * INV_255
    vf = v * INV_255
    c = vf * sf
    hp = hdeg * INV_60
    x = c * (1 - torch.abs(torch.remainder(hp, 2.0) - 1))
    z = torch.zeros_like(c)
    idx = torch.clamp(hp.to(torch.int32), 0, 5)  # truncates, as astype(int32)
    # sector -> (r, g, b) of (c, x, 0); the sectors are disjoint
    table = ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x))
    r, g, b = z, z, z
    for k, (rk, gk, bk) in enumerate(table):
        sel = idx == k
        r, g, b = torch.where(sel, rk, r), torch.where(sel, gk, g), torch.where(sel, bk, b)
    m = vf - c
    return torch.stack([r + m, g + m, b + m], dim=-1)


def hsv_jitter_device(img01: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """HSV channel-gain jitter on float RGB in [0, 1]; ``gains`` (N, 3) like the cv2 LUTs:
    ``(h * r_h) % 180``, ``clip(s * r_s)``, ``clip(v * r_v)``."""
    h, s, v = rgb_to_hsv_cv(img01)
    g = gains[:, None, None, :]
    h = torch.remainder(h * g[..., 0], 180.0)
    s = torch.clamp(s * g[..., 1], 0.0, 255.0)
    v = torch.clamp(v * g[..., 2], 0.0, 255.0)
    return hsv_to_rgb_cv(h, s, v)


def _targets(mask: torch.Tensor, binary: bool, num_classes: int | None) -> torch.Tensor:
    if binary:
        return (mask > 0).to(torch.int32)
    if num_classes is not None:
        # labels >= num_classes become the ignore class (hf_dataloader.py:87)
        return torch.where(mask >= num_classes, torch.full_like(mask, num_classes), mask)
    return mask


def paste_coords(valid_wh: torch.Tensor, params: AugParams, canvas_hw: tuple[int, int],
                 out_hw: tuple[int, int]):
    """The geometry of the paste-resample: (yc, yv, xc, xv), each (N, H_out) or (N, W_out).

    Source coordinates in the canvas and whether the output pixel lies in
    the pasted rectangle, per axis, from the parameters ``params`` and the
    letterboxed content's (nw, nh).
    """
    ar_a, ar_b, scale, flip, px, py, _ = params
    ch, cw = canvas_hw
    h_out, w_out = out_hw
    nw, nh = valid_wh[:, 0], valid_wh[:, 1]
    # new aspect ratio and pasted-rectangle size (hf_dataloader.py:135-143),
    # floor()ed like the reference's int() casts
    new_ar = (nw / nh) * ar_a / ar_b
    portrait = new_ar < 1
    zero = torch.zeros_like(new_ar)
    nh_new = torch.where(portrait, torch.floor(scale * h_out), zero)
    nw_new = torch.where(portrait, torch.floor(nh_new * new_ar), zero)
    nw_new = torch.where(portrait, nw_new, torch.floor(scale * w_out))
    nh_new = torch.where(portrait, nh_new, torch.floor(nw_new / new_ar))
    nw_new = torch.clamp(nw_new, min=1.0)
    nh_new = torch.clamp(nh_new, min=1.0)

    # random placement: dx ~ U(0, w - nw_new), negative when the pasted rect
    # is larger than the canvas, exactly like the reference
    dx = torch.floor(px * (w_out - nw_new))
    dy = torch.floor(py * (h_out - nh_new))

    # source content rectangle inside the cached canvas (centred letterbox)
    src_x0 = (cw - nw) / 2.0
    src_y0 = (ch - nh) / 2.0
    xc, xv = axis_coords(w_out, nw_new, dx, src_x0, nw, flip)
    yc, yv = axis_coords(h_out, nh_new, dy, src_y0, nh, None)
    return yc, yv, xc, xv


def augment_batch(
    canvas_img: torch.Tensor,  # (N, C, C, 3) uint8, letterboxed, gray fill
    canvas_mask: torch.Tensor,  # (N, C, C) uint8 or int
    valid_wh: torch.Tensor,  # (N, 2) float32: letterboxed content (nw, nh)
    generator: torch.Generator | None = None,
    params: AugParams | None = None,
    out_hw: tuple[int, int] = (512, 512),
    jitter: float = 0.3,
    hue: float = 0.1,
    sat: float = 0.7,
    val: float = 0.3,
    binary: bool = True,
    num_classes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random-augment a batch of canvases on their device.

    The parameters come from ``params`` (``sample_params``' seven tensors,
    on the batch's device) or are drawn from ``generator``. Returns (images
    (N, H, W, 3) float32 in [0, 1], masks (N, H, W) int32).
    """
    if (generator is None) == (params is None):
        raise ValueError("pass exactly one of generator and params")
    if params is None:
        params = sample_params(generator, canvas_img.shape[0], jitter, hue, sat, val)

    with torch.autocast(canvas_img.device.type, enabled=False):
        yc, yv, xc, xv = paste_coords(valid_wh, params, tuple(canvas_img.shape[1:3]), out_hw)
        inside = (yv[:, :, None] & xv[:, None, :])[..., None]

        img = canvas_img.to(torch.float32) * INV_255
        img = _resample(_resample(img, yc, "bilinear", 1), xc, "bilinear", 2)
        img = torch.where(inside, img, torch.full_like(img[:1, :1, :1], 128.0 / 255.0))

        mask = canvas_mask.to(torch.float32)[..., None]
        mask = _resample(_resample(mask, yc, "nearest", 1), xc, "nearest", 2)
        mask = torch.where(inside, mask, torch.zeros_like(mask[:1, :1, :1]))[..., 0]
        mask = torch.round(mask).to(torch.int32)

        img = hsv_jitter_device(img, params[6])
    return img, _targets(mask, binary, num_classes)


def preprocess_eval_batch(
    canvas_img: torch.Tensor,
    canvas_mask: torch.Tensor,
    binary: bool = True,
    num_classes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval path: the cached canvas is the letterboxed input; only normalise it to [0, 1]."""
    img = canvas_img.to(torch.float32) * INV_255
    return img, _targets(canvas_mask.to(torch.int32), binary, num_classes)
