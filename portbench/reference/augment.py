"""A frozen copy of the program's on-card augmentation, in plain PyTorch.

Copied from ``unet_embroidery_seg_torch/ops/device_augment.py`` (bilinear
image and nearest mask paste-resample with aspect jitter, scale, flip and
placement, then the cv2-convention HSV jitter) and ``engine/resident.py``'s
``step_seeds``, so that the reference draws, from the same step seeds on
the same kind of device, the parameters the program draws, and computes
the batch again itself. It imports nothing of the program; a later change
to the program's augmentation does not reach it.
"""

from __future__ import annotations

import numpy as np
import torch

INV_255, INV_60 = 1.0 / 255.0, 1.0 / 60.0


def step_seeds(seed: int, epoch: int, it: int) -> tuple[int, int]:
    """(dropout seed, augmentation seed) of step ``it`` of ``epoch``."""
    a, b = np.random.SeedSequence((seed, epoch, it)).generate_state(2)
    return int(a), int(b)


def sample_params(generator: torch.Generator, n: int, jitter=0.3, hue=0.1, sat=0.7, val=0.3):
    dev = generator.device

    def u(lo=0.0, hi=1.0, shape=(n,)):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    ar_a = u(1 - jitter, 1 + jitter)
    ar_b = u(1 - jitter, 1 + jitter)
    scale = u(0.25, 2.0)
    flip = u() < 0.5
    place_x, place_y = u(), u()
    hsv_r = torch.stack([u(-1.0, 1.0) * g + 1.0 for g in (hue, sat, val)], dim=1)
    return ar_a, ar_b, scale, flip, place_x, place_y, hsv_r


def _axis(out_size, n_new, offset, src_lo, src_extent, flip):
    p = torch.arange(out_size, dtype=torch.float32, device=n_new.device)[None, :]
    rel = p - offset[:, None]
    valid = (rel >= 0) & (rel < n_new[:, None])
    t = (rel + 0.5) / torch.clamp(n_new[:, None], min=1.0)
    if flip is not None:
        t = torch.where(flip[:, None], 1.0 - t, t)
    return t * src_extent[:, None] - 0.5 + src_lo[:, None], valid


def _taps(coords, in_size, mode):
    c = torch.clamp(coords, 0.0, in_size - 1)
    if mode == "nearest":
        return [(torch.clamp(torch.floor(c + 0.5), 0, in_size - 1).long(), None)]
    i0 = torch.floor(c)
    return [(i.clamp(max=in_size - 1).long(), torch.clamp(1.0 - torch.abs(c - i), 0.0, 1.0))
            for i in (i0, i0 + 1.0)]


def _resample(x, coords, mode, axis):
    n, in_size = x.shape[0], x.shape[axis]
    xs = x if axis == 1 else x.transpose(1, 2)
    flat = xs.reshape(n * in_size, -1)
    base = torch.arange(n, device=x.device)[:, None] * in_size
    out = None
    for idx, w in _taps(coords, in_size, mode):
        rows = flat.index_select(0, (idx + base).reshape(-1)).reshape(n, idx.shape[1], -1)
        term = rows if w is None else w[:, :, None] * rows
        out = term if out is None else out + term
    out = out.reshape(n, idx.shape[1], xs.shape[2], xs.shape[3])
    return out if axis == 1 else out.transpose(1, 2)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.amax(dim=-1), rgb.amin(dim=-1)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, zero)
    h = torch.where(maxc == g, 2.0 + rc - bc, h)
    h = torch.where(maxc == b, 4.0 + gc - rc, h)
    h = torch.where(delta > 0, h, zero)
    h = torch.remainder(h * 60.0, 360.0)
    return h / 2.0, s * 255.0, maxc * 255.0


def _hsv_to_rgb(h, s, v):
    sf, vf = s * INV_255, v * INV_255
    c = vf * sf
    hp = h * 2.0 * INV_60
    x = c * (1 - torch.abs(torch.remainder(hp, 2.0) - 1))
    z = torch.zeros_like(c)
    idx = torch.clamp(hp.to(torch.int32), 0, 5)
    table = ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x))
    r, g, b = z, z, z
    for k, (rk, gk, bk) in enumerate(table):
        sel = idx == k
        r, g, b = torch.where(sel, rk, r), torch.where(sel, gk, g), torch.where(sel, bk, b)
    m = vf - c
    return torch.stack([r + m, g + m, b + m], dim=-1)


def augment(canvas_img, canvas_mask, valid_wh, params, out_hw):
    """(images (N, H, W, 3) f32 in [0, 1], binary targets (N, H, W) int32) of one batch."""
    ar_a, ar_b, scale, flip, px, py, hsv_r = params
    ch, cw = canvas_img.shape[1:3]
    h_out, w_out = out_hw
    nw, nh = valid_wh[:, 0], valid_wh[:, 1]
    new_ar = (nw / nh) * ar_a / ar_b
    portrait = new_ar < 1
    zero = torch.zeros_like(new_ar)
    nh_new = torch.where(portrait, torch.floor(scale * h_out), zero)
    nw_new = torch.where(portrait, torch.floor(nh_new * new_ar), zero)
    nw_new = torch.where(portrait, nw_new, torch.floor(scale * w_out))
    nh_new = torch.where(portrait, nh_new, torch.floor(nw_new / new_ar))
    nw_new, nh_new = torch.clamp(nw_new, min=1.0), torch.clamp(nh_new, min=1.0)
    dx = torch.floor(px * (w_out - nw_new))
    dy = torch.floor(py * (h_out - nh_new))
    xc, xv = _axis(w_out, nw_new, dx, (cw - nw) / 2.0, nw, flip)
    yc, yv = _axis(h_out, nh_new, dy, (ch - nh) / 2.0, nh, None)
    inside = (yv[:, :, None] & xv[:, None, :])[..., None]
    img = canvas_img.to(torch.float32) * INV_255
    img = _resample(_resample(img, yc, "bilinear", 1), xc, "bilinear", 2)
    img = torch.where(inside, img, torch.full_like(img[:1, :1, :1], 128.0 / 255.0))
    mask = canvas_mask.to(torch.float32)[..., None]
    mask = _resample(_resample(mask, yc, "nearest", 1), xc, "nearest", 2)
    mask = torch.where(inside, mask, torch.zeros_like(mask[:1, :1, :1]))[..., 0]
    mask = torch.round(mask).to(torch.int32)
    hh, ss, vv = _rgb_to_hsv(img)
    g = hsv_r[:, None, None, :]
    img = _hsv_to_rgb(torch.remainder(hh * g[..., 0], 180.0),
                      torch.clamp(ss * g[..., 1], 0.0, 255.0),
                      torch.clamp(vv * g[..., 2], 0.0, 255.0))
    return img, (mask > 0).to(torch.int32)
