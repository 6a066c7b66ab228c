"""Raw sample sources (copy of ``unet_embroidery_seg_tpu/data/sources.py``).

PIL is imported inside the functions that draw or read images, so the
port's compute path needs no image library.

The JAX package's description follows.

Raw sample sources: HF parquet datasets + a synthetic fallback.

Parity target: the dataset-loading half of ``HFUnetDataset``
(the reference's utils/hf_dataloader.py:17-62): samples come from
``datasets.load_dataset(f"{data_dir}/{config}", split=...)`` with a
project-local cache dir, and each record has image/mask (PIL) plus
``label``/``filename`` string columns.

The synthetic source exists because this framework must be testable and
benchmarkable without network access: it procedurally draws embroidery-like
blobs (images + consistent masks + one of the three class labels) with
deterministic per-index randomness, mimicking the real data's shape
diversity (variable image sizes, RGB images, L masks).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# 类别名称到索引的映射 (hf_dataloader.py:21-25)
CLASS_TO_IDX = {
    "动物类": 0,
    "植物类": 1,
    "复合类": 2,
}
CLASS_NAMES = list(CLASS_TO_IDX.keys())

SPLIT_SIZES = {  # synthetic split sizes (arbitrary but train>val>test)
    "train": 64,
    "validation": 16,
    "test": 8,
}


def class_index_from_label(label_name: str) -> int:
    """Prefix-match the label field to a class index (hf_dataloader.py:94-103).

    Unknown labels default to 0 (动物类), like the reference's for/else.
    """
    for class_name, idx in CLASS_TO_IDX.items():
        if label_name.startswith(class_name):
            return idx
    return 0


class HFParquetSource:
    """Samples from a local HF dataset directory ``{data_dir}/{config}``."""

    def __init__(
        self,
        data_dir: str,
        config: str = "full",
        split: str = "train",
        cache_dir: str | None = None,
    ):
        from datasets import load_dataset

        dataset_path = f"{data_dir}/{config}"
        cache_dir = cache_dir or os.environ.get("HF_DATASETS_CACHE") or ".hf-cache/datasets"
        os.makedirs(cache_dir, exist_ok=True)
        self.dataset = load_dataset(dataset_path, split=split, cache_dir=cache_dir)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> dict:
        sample = self.dataset[int(index)]
        return {
            "image": sample["image"].convert("RGB"),
            "mask": sample["mask"].convert("L"),
            "label": sample.get("label", "unknown"),
            "filename": sample.get("filename", f"sample_{index}"),
        }


@dataclass
class SyntheticSource:
    """Procedural embroidery-like samples for offline tests and benches."""

    split: str = "train"
    length: int | None = None
    seed: int = 0
    size_range: tuple[int, int] = (320, 768)
    # >1: each blob's mask pixel is a class id in 1..mask_classes (for
    # multiclass parity studies). The default 1 draws no extra random
    # numbers, so existing binary streams stay bit-identical.
    mask_classes: int = 1
    # Opt-in knobs for the scaled multitask parity regime (PARITY.md): a
    # higher blob count raises the foreground fraction (~0.18 at defaults)
    # so the multitask head's UNWEIGHTED seg BCE (neither framework applies
    # pos_weight under multitask — the reference's train.py:341-344) has a
    # balanced target instead of collapsing to a trivial predictor, and
    # "visual" labels derive the class from image content (dominant mean
    # blob color channel) so the cls head has learnable signal instead of
    # the default's image-independent random class. Defaults draw the exact
    # RNG stream of prior rounds' exports.
    n_blobs_range: tuple[int, int] = (1, 5)
    label_mode: str = "random"  # or "visual"

    def __post_init__(self):
        if self.length is None:
            self.length = SPLIT_SIZES.get(self.split, 16)
        self._split_salt = {"train": 0, "validation": 1, "test": 2}.get(self.split, 3)

    def __len__(self) -> int:
        return int(self.length)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image, ImageDraw

        rng = np.random.default_rng((self.seed, self._split_salt, int(index)))
        w = int(rng.integers(self.size_range[0], self.size_range[1]))
        h = int(rng.integers(self.size_range[0], self.size_range[1]))
        bg = tuple(int(v) for v in rng.integers(30, 226, 3))
        image = Image.new("RGB", (w, h), bg)
        mask = Image.new("L", (w, h), 0)
        idraw = ImageDraw.Draw(image)
        mdraw = ImageDraw.Draw(mask)
        n_blobs = int(rng.integers(*self.n_blobs_range))
        colors = []
        for _ in range(n_blobs):
            cx, cy = rng.integers(0, w), rng.integers(0, h)
            rx = int(rng.integers(w // 10, max(w // 3, w // 10 + 1)))
            ry = int(rng.integers(h // 10, max(h // 3, h // 10 + 1)))
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            colors.append(color)
            box = (cx - rx, cy - ry, cx + rx, cy + ry)
            idraw.ellipse(box, fill=color)
            fill = (
                1 if self.mask_classes == 1
                else int(rng.integers(1, self.mask_classes + 1))
            )
            mdraw.ellipse(box, fill=fill)
        if self.label_mode == "visual":
            # Class = dominant channel of the mean blob color — derivable
            # from the image (a global color statistic that survives the
            # reference's mild hue/sat jitter), so the cls head can beat
            # chance. Drawn AFTER the loop with no extra rng draws.
            cls = CLASS_NAMES[int(np.argmax(np.mean(colors, axis=0)))]
        else:
            cls = CLASS_NAMES[int(rng.integers(0, 3))]
        return {
            "image": image,
            "mask": mask,
            "label": f"{cls}{index}",
            "filename": f"synthetic_{self.split}_{index}.jpg",
        }


class VOCSource:
    """Raw VOC-tree sample source (legacy-path parity: utils/dataloader.py).

    Reads ``{data_path}/VOC2012/ImageSets/Segmentation/{split}.txt`` id lists
    and serves JPEGImages/{id}.jpg + SegmentationClass/{id}.png pairs; the
    same SegmentationDataset transforms apply on top. The reference keeps an
    equivalent torch Dataset that its entry points no longer use
    (the reference's utils/dataloader.py:10-34); here it also backs
    ``open_source`` for ``--data-path`` values pointing at a VOCdevkit tree.
    """

    SPLIT_TXT = {"train": "train.txt", "validation": "val.txt", "test": "test.txt"}

    def __init__(self, data_path: str, split: str = "train"):
        txt = self.SPLIT_TXT.get(split, f"{split}.txt")
        list_path = os.path.join(data_path, "VOC2012", "ImageSets", "Segmentation", txt)
        with open(list_path, "r", encoding="utf-8") as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.jpeg_dir = os.path.join(data_path, "VOC2012", "JPEGImages")
        self.mask_dir = os.path.join(data_path, "VOC2012", "SegmentationClass")

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image

        name = self.ids[int(index)]
        image = None
        for ext in (".jpg", ".png", ".jpeg"):
            p = os.path.join(self.jpeg_dir, name + ext)
            if os.path.exists(p):
                image = Image.open(p)
                break
        if image is None:
            raise FileNotFoundError(f"image for id {name} not found in {self.jpeg_dir}")
        mask = Image.open(os.path.join(self.mask_dir, name + ".png"))
        return {
            "image": image.convert("RGB"),
            "mask": mask.convert("L"),
            "label": name,
            "filename": name,
        }


def open_source(
    data_dir: str,
    config: str,
    split: str,
    cache_dir: str | None = None,
):
    """Open the HF parquet source, or the synthetic fallback.

    ``data_dir == "synthetic"`` (or "synthetic:<n>") forces the fallback; a
    missing local dataset directory falls back too (with a warning) so the
    pipeline stays runnable on air-gapped machines.
    """
    if data_dir.startswith("synthetic"):
        length = None
        if ":" in data_dir:
            length = int(data_dir.split(":", 1)[1])
        return SyntheticSource(split=split, length=length)
    if os.path.isdir(os.path.join(data_dir, "VOC2012")):
        return VOCSource(data_dir, split=split)
    if not os.path.isdir(os.path.join(data_dir, config)):
        print(
            f"[WARN] dataset not found at {data_dir}/{config}; "
            "falling back to the synthetic source (pass --data-path synthetic to silence)"
        )
        return SyntheticSource(split=split)
    return HFParquetSource(data_dir, config=config, split=split, cache_dir=cache_dir)
