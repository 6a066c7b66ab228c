"""Host-side augmentation (copy of ``unet_embroidery_seg_tpu/data/augment.py``).

Reference-parity semantics (``HFUnetDataset.get_random_data``):

  eval:  aspect-preserving BICUBIC resize, paste centered on a gray-128
         canvas (mask on black) -- the letterbox transform;
  train: aspect jitter (+-0.3 as a ratio of two uniforms), scale [0.25, 2],
         BICUBIC/NEAREST resize, h-flip p=0.5, random placement on the
         canvas, then HSV LUT jitter (hue .1, sat .7, val .3) via cv2, or
         its numpy version where cv2 is missing.

Randomness is an explicit ``np.random.Generator`` per sample, derived from
(seed, epoch, index). PIL and cv2 are imported inside the functions: the
port's compute path needs no image library.
"""

from __future__ import annotations

import numpy as np

GRAY_FILL = (128, 128, 128)


def _rand(rng: np.random.Generator, a: float = 0.0, b: float = 1.0) -> float:
    return float(rng.random() * (b - a) + a)


def letterbox(image, label, input_shape: tuple[int, int]):
    """Eval-mode transform: aspect-preserving resize + center paste.

    (image, label) PIL pair -> letterboxed (image, label) of ``input_shape`` (h, w).
    """
    from PIL import Image

    image = image.convert("RGB") if image.mode != "RGB" else image
    iw, ih = image.size
    h, w = input_shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)

    image = image.resize((nw, nh), Image.BICUBIC)
    new_image = Image.new("RGB", (w, h), GRAY_FILL)
    new_image.paste(image, ((w - nw) // 2, (h - nh) // 2))

    label = label.resize((nw, nh), Image.NEAREST)
    new_label = Image.new("L", (w, h), 0)
    new_label.paste(label, ((w - nw) // 2, (h - nh) // 2))
    return new_image, new_label


def hsv_jitter(
    image_u8: np.ndarray, r: np.ndarray
) -> np.ndarray:
    """cv2 LUT-based HSV jitter; ``r`` is the 3-vector of channel gains."""
    try:
        import cv2
    except ImportError:  # numpy fallback, same math
        cv2 = None
    if cv2 is None:  # numpy fallback, same math
        hsv = _rgb_to_hsv_u8(image_u8)
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        x = np.arange(256, dtype=r.dtype)
        lut_h = ((x * r[0]) % 180).astype(np.uint8)
        lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
        lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
        hsv = np.stack([lut_h[h], lut_s[s], lut_v[v]], axis=-1)
        return _hsv_to_rgb_u8(hsv)
    hue, sat, val = cv2.split(cv2.cvtColor(image_u8, cv2.COLOR_RGB2HSV))
    x = np.arange(256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(image_u8.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(image_u8.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(image_u8.dtype)
    merged = cv2.merge(
        (cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val))
    )
    return cv2.cvtColor(merged, cv2.COLOR_HSV2RGB)


def random_augment(
    image,
    label,
    input_shape: tuple[int, int],
    rng: np.random.Generator,
    jitter: float = 0.3,
    hue: float = 0.1,
    sat: float = 0.7,
    val: float = 0.3,
):
    """Train-mode transform of a PIL (image, label) pair. Returns (uint8 HWC image array, PIL label)."""
    from PIL import Image

    image = image.convert("RGB") if image.mode != "RGB" else image
    iw, ih = image.size
    h, w = input_shape

    new_ar = iw / ih * _rand(rng, 1 - jitter, 1 + jitter) / _rand(rng, 1 - jitter, 1 + jitter)
    scale = _rand(rng, 0.25, 2)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)

    image = image.resize((nw, nh), Image.BICUBIC)
    label = label.resize((nw, nh), Image.NEAREST)

    if _rand(rng) < 0.5:
        image = image.transpose(Image.FLIP_LEFT_RIGHT)
        label = label.transpose(Image.FLIP_LEFT_RIGHT)

    dx = int(_rand(rng, 0, w - nw))
    dy = int(_rand(rng, 0, h - nh))
    new_image = Image.new("RGB", (w, h), GRAY_FILL)
    new_label = Image.new("L", (w, h), 0)
    new_image.paste(image, (dx, dy))
    new_label.paste(label, (dx, dy))

    image_data = np.array(new_image, np.uint8)
    r = rng.uniform(-1, 1, 3) * np.array([hue, sat, val]) + 1
    image_data = hsv_jitter(image_data, r)
    return image_data, new_label


def _rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """OpenCV-convention uint8 RGB->HSV (H in [0,180))."""
    rgbf = rgb.astype(np.float32) / 255.0
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    maxc = np.max(rgbf, axis=-1)
    minc = np.min(rgbf, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    hdeg = np.zeros_like(maxc)
    mask = delta > 0
    rc = np.where(mask, (maxc - r) / np.maximum(delta, 1e-12), 0)
    gc = np.where(mask, (maxc - g) / np.maximum(delta, 1e-12), 0)
    bc = np.where(mask, (maxc - b) / np.maximum(delta, 1e-12), 0)
    hdeg = np.where((maxc == r) & mask, bc - gc, hdeg)
    hdeg = np.where((maxc == g) & mask, 2.0 + rc - bc, hdeg)
    hdeg = np.where((maxc == b) & mask, 4.0 + gc - rc, hdeg)
    hdeg = (hdeg * 60.0) % 360.0
    return np.stack(
        [
            np.round(hdeg / 2.0).astype(np.uint8),
            np.round(s * 255.0).astype(np.uint8),
            np.round(v * 255.0).astype(np.uint8),
        ],
        axis=-1,
    )


def _hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """OpenCV-convention uint8 HSV->RGB."""
    h = hsv[..., 0].astype(np.float32) * 2.0
    s = hsv[..., 1].astype(np.float32) / 255.0
    v = hsv[..., 2].astype(np.float32) / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    zeros = np.zeros_like(c)
    conds = [
        (hp < 1, (c, x, zeros)),
        ((hp >= 1) & (hp < 2), (x, c, zeros)),
        ((hp >= 2) & (hp < 3), (zeros, c, x)),
        ((hp >= 3) & (hp < 4), (zeros, x, c)),
        ((hp >= 4) & (hp < 5), (x, zeros, c)),
        (hp >= 5, (c, zeros, x)),
    ]
    r = np.zeros_like(c)
    g = np.zeros_like(c)
    b = np.zeros_like(c)
    for cond, (rr, gg, bb) in conds:
        r = np.where(cond, rr, r)
        g = np.where(cond, gg, g)
        b = np.where(cond, bb, b)
    m = v - c
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
