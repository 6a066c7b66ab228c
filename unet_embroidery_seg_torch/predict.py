"""Inference CLI (port of the repo-root ``predict.py``).

``python -m unet_embroidery_seg_torch.predict --data_path IMG_OR_DIR --weights best.pth``

Single image or directory; 480x480 letterbox (the reference hardcodes 480),
softmax -> un-pad crop -> resize back -> argmax -> VOC-palette / HSV
colourise -> alpha-0.7 blend, saved as ``*_mask.png`` under
``run/predict/expN``. Runs on the card (``--device cuda``, the default) and
raises without one; ``--device cpu`` runs the kernels' plain versions.

PIL and cv2 are imported only inside the functions that read and write
image files; the compute path needs neither.
"""

from __future__ import annotations

import colorsys
import os
import time
from pathlib import Path

import numpy as np
import torch

from unet_embroidery_seg_torch.data.augment import letterbox
from unet_embroidery_seg_torch.engine import checkpoint, host_copy, steps
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.utils.device import resolve_device, set_float32_precision
from unet_embroidery_seg_torch.utils.exp_folder import create_val_exp_folder
from unet_embroidery_seg_torch.utils.profiling import span

VOC_COLORS = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (192, 0, 0),
    (64, 128, 0), (192, 128, 0), (64, 0, 128), (192, 0, 128), (64, 128, 128),
    (192, 128, 128), (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0),
    (0, 64, 128), (128, 64, 128),
]


def resolve_amp_default(model: str, loss: str, task: str = "binary") -> bool:
    """Default compute dtype per config (copy of ``train.py:resolve_amp_default``).

    bf16 for every config: the matched-init study in PARITY.md found no
    systematic f32 advantage. The signature stays so predict mirrors
    whatever per-config rule training installs.
    """
    del model, loss, task
    return True


def time_synchronized(device: torch.device) -> float:
    """Wait for the card's queue to drain, then timestamp."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def make_colors(num_classes: int):
    if num_classes <= 21:
        return VOC_COLORS
    hsv = [(x / num_classes, 1.0, 1.0) for x in range(num_classes)]
    colors = [colorsys.hsv_to_rgb(*t) for t in hsv]
    return [(int(r * 255), int(g * 255), int(b * 255)) for r, g, b in colors]


def load_model(model_name: str, model_path: str, num_classes: int, amp: bool,
               decoder_width: float = 1.0, device: str | torch.device = "cuda"):
    """predict_fn of a model restored strictly from a ``.pth`` checkpoint."""
    model = build_model(model_name, num_classes, decoder_width=decoder_width,
                        device=device)
    checkpoint.load_weights(model_path, model)
    return steps.make_predict_fn(model, amp)


def predict_probs(predict_fn, canvases: np.ndarray) -> np.ndarray:
    """Softmax probabilities (N, H, W, K) of a batch of NHWC float32 canvases.

    From a card the probabilities come through ``engine/host_copy.download``'s
    page-locked slots into a fresh array the caller owns.

    Spans (while a profiler records): ``predict.call``, and inside it
    ``predict_fn``'s own (``predict.h2d``, ``predict.forward``) and
    ``predict.d2h``, the softmax and the probabilities' copy to the host.
    """
    with span("predict.call"):
        logits = predict_fn(canvases)
        with span("predict.d2h"):
            probs = torch.softmax(logits, dim=-1)
            return host_copy.download(probs) if probs.is_cuda else probs.cpu().numpy()


def load_and_letterbox(file_path: str, input_size: int):
    """Open + letterbox one image; returns (x_f32_canvas, meta) or None."""
    from PIL import Image

    try:
        image = Image.open(file_path)
    except (FileNotFoundError, IOError) as e:
        print(f"Error opening image: {e}")
        return None
    image = image.convert("RGB")
    iw, ih = image.size
    scale = min(input_size / iw, input_size / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dummy_mask = Image.new("L", image.size, 0)
    image_data, _ = letterbox(image, dummy_mask, (input_size, input_size))
    x = np.array(image_data, np.float32) / 255.0
    meta = {"file_path": file_path, "image": image, "nw": nw, "nh": nh}
    return x, meta


def save_mask(pr_softmax: np.ndarray, meta: dict, num_classes: int, exp_folder: str,
              input_size: int, mix_type: bool) -> None:
    """Un-pad crop -> resize to original -> argmax -> colourise -> save."""
    import cv2
    from PIL import Image

    old_img = meta["image"]
    original_w, original_h = old_img.size
    nw, nh = meta["nw"], meta["nh"]
    top = (input_size - nh) // 2
    left = (input_size - nw) // 2
    pr = pr_softmax[top : top + nh, left : left + nw]
    pr = cv2.resize(pr, (original_w, original_h), interpolation=cv2.INTER_LINEAR)
    pr = pr.argmax(axis=-1)

    colors = make_colors(num_classes)
    seg_img = np.reshape(
        np.array(colors, np.uint8)[np.reshape(pr, [-1])], [original_h, original_w, -1]
    )
    if mix_type:
        alpha = 0.7
        out = Image.fromarray(cv2.addWeighted(np.array(old_img), 1 - alpha, seg_img, alpha, 0))
    else:
        out = Image.fromarray(np.uint8(seg_img))

    mask_filename = os.path.splitext(os.path.basename(meta["file_path"]))[0] + "_mask.png"
    save_path = os.path.join(exp_folder, mask_filename)
    out.save(save_path)
    print(f"Mask saved at: {save_path}")


def detect_image(file_path: str, predict_fn, num_classes: int, exp_folder: str,
                 input_size: int = 480, mix_type: bool = True) -> None:
    prepared = load_and_letterbox(file_path, input_size)
    if prepared is None:
        return
    x, meta = prepared
    pr = predict_probs(predict_fn, x[None])[0]
    save_mask(pr, meta, num_classes, exp_folder, input_size, mix_type)


def detect_batch(file_paths: list[str], batch: int, predict_fn, num_classes: int,
                 exp_folder: str, input_size: int = 480, mix_type: bool = True) -> None:
    """Directory inference, ``batch`` images per forward (the last batch may be smaller)."""
    for start in range(0, len(file_paths), batch):
        prepared = [load_and_letterbox(p, input_size) for p in file_paths[start : start + batch]]
        prepared = [p for p in prepared if p is not None]
        if not prepared:
            continue
        prs = predict_probs(predict_fn, np.stack([x for x, _ in prepared]))
        for (_, meta), pr in zip(prepared, prs):
            save_mask(pr, meta, num_classes, exp_folder, input_size, mix_type)


def predict(args) -> str:
    device = resolve_device(args.device)
    set_float32_precision()
    exp_folder = create_val_exp_folder()
    num_classes = args.num_classes + 1
    if not os.path.exists(args.weights):
        raise FileNotFoundError(f"weights {args.weights} not found.")
    if args.amp is None:
        task = "binary" if args.num_classes == 1 else "multiclass"
        args.amp = resolve_amp_default(args.model, args.loss, task)

    predict_fn = load_model(args.model, args.weights, num_classes, args.amp,
                            decoder_width=args.decoder_width, device=device)

    if os.path.isdir(args.data_path):
        file_paths = sorted(
            str(p) for p in Path(args.data_path).rglob("*")
            if p.suffix in (".jpg", ".png", ".jpeg")
        )
    elif os.path.isfile(args.data_path):
        file_paths = [args.data_path]
    else:
        raise ValueError(f"Unsupported input path: {args.data_path}")

    file_paths = [p for p in file_paths if p.endswith((".jpg", ".png", ".jpeg"))]
    t_start = time_synchronized(device)
    if args.batch > 1 and len(file_paths) > 1:
        detect_batch(file_paths, args.batch, predict_fn, num_classes, exp_folder,
                     input_size=args.input_size, mix_type=args.mix_type)
    else:
        for file_path in file_paths:
            detect_image(file_path, predict_fn, num_classes, exp_folder,
                         input_size=args.input_size, mix_type=args.mix_type)
    t_end = time_synchronized(device)
    print(f"inference time for: {t_end - t_start}")
    return exp_folder


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="U-Net predict (PyTorch/CUDA port)")
    parser.add_argument("--data_path", default="samples/example.jpg", help="data root")
    parser.add_argument("--weights", default="run/train/exp/weights/best.pth")
    parser.add_argument("--num-classes", default=1, type=int,
                        help="Foreground classes (output channels = this + 1)")
    parser.add_argument("--model", default="unet_resnet50", choices=sorted(SUPPORTED_MODELS))
    parser.add_argument("--decoder-width", default=1.0, type=float,
                        help="unet_resnet50 only: must match the checkpoint's width")
    parser.add_argument("--input-size", default=480, type=int,
                        help="Inference letterbox size (reference hardcodes 480)")
    parser.add_argument("--mix_type", default=True, action=argparse.BooleanOptionalAction,
                        help="Alpha-blend the mask over the original image")
    parser.add_argument("--loss", default="lovasz_hinge",
                        help="Loss the checkpoint was trained with; only used to "
                             "resolve the default compute dtype as training does")
    parser.add_argument("--amp", default=None, action=argparse.BooleanOptionalAction,
                        help="bf16 inference (default: per config, as in training)")
    parser.add_argument("--batch", default=1, type=int,
                        help="Directory inference batch size (1 = per-image loop)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda raises without a card, cpu runs the "
                             "kernels' plain versions")
    return parser.parse_args(argv)


if __name__ == "__main__":
    predict(parse_args())
