"""Eval-mode letterbox (copy of ``unet_embroidery_seg_tpu/data/augment.py:letterbox``).

Aspect-preserving BICUBIC resize pasted centred on a gray-128 canvas, the
mask NEAREST on black (the reference's ``get_random_data`` eval branch).
PIL is imported inside the function: the port's compute path needs no
image library.
"""

from __future__ import annotations

GRAY_FILL = (128, 128, 128)


def letterbox(image, label, input_shape: tuple[int, int]):
    """(image, label) PIL pair -> letterboxed (image, label) of ``input_shape`` (h, w)."""
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
