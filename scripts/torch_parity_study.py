#!/usr/bin/env python3
"""End-to-end accuracy of the port against the published bands: ``TORCH_PARITY.json``.

    python scripts/torch_parity_study.py [--arms ...] [--seeds ...] \
        [--data build/parity_ds] [--out TORCH_PARITY.json] [--device cuda]

The port's counterpart of what ``scripts/parity_study.py`` and
``scripts/parity_matched_init.py`` measure: each arm trains the port's
train CLI (in this process, ``pipeline.run_fit``) once per seed at the
regime of ``PARITY_MATCHED_INIT.json`` (40 epochs, 256^2, batch 8) and
records the test split's metrics. The arms:

- ``resnet_lovasz/bf16``: unet_resnet50 + Lovasz at the CLI's default
  (bf16 autocast), seeds 0-7;
- ``resnet_lovasz/f32_tf32``: the same with ``--no-amp`` and cuDNN's TF32
  on, as the CLI sets it (``utils/device.set_float32_precision``), seeds 0-7;
- ``resnet_lovasz/f32_no_tf32``: ``--no-amp`` with cuDNN's TF32 off: the
  fit runs with the CLI's ``set_float32_precision`` replaced in this
  process (the CLI has no flag for it, as the JAX CLI has none), seeds 0-7;
- ``plain_bce/bf16``: unet_plain + BCE at the CLI's default, seeds 0-2.

Two diagnostic arms run only when ``--arms`` names them:

- ``resnet_lovasz/bf16_host_input``: the bf16 arm on the host input path
  (``--no-device-augment``: PIL augmentation per sample, as the reference
  trains), seeds 0-7: it tells the device-resident input path apart from
  the rest of the fit;
- ``resnet_lovasz/bf16_torch_conv_bias``: the bf16 arm from the CLI's
  init at each seed but with every conv bias drawn as torch's default
  (uniform within 1/sqrt(fan_in)), which the reference's ``weights_init``
  does not touch and the port's init zeroes; passed as ``--weights``,
  seeds 0-7, paired with the bf16 arm's.

Data: 64 / 16 / 16 ``SyntheticSource`` samples (seed 0), the splits that
``scripts/export_parity_dataset.py`` writes, under config ``no-ai``. Where
``datasets`` is installed the tree is that script's parquet layout;
elsewhere a VOC tree (``VOC2012/ImageSets/Segmentation/{train,val,test}.txt``,
PNG images in ``JPEGImages/``, masks in ``SegmentationClass/``), which
decodes to the same samples (PNG is lossless). The tree is checked before
any fit: ``open_source`` would replace a missing one by synthetic data
with only a warning.

Each arm is held against the bands of ``PARITY.md`` (the reference's
torch CPU f32 runs and the JAX package's, test IoU, mean +- std): it
passes a band when its mean lies within one standard deviation of the
band's mean; the f32 arms must also have Welch's 95% confidence interval
of the difference against the reference cover 0. Beside them, not in the
verdict, each arm is held against the JAX package's unpaired runs
(``jax_unpaired``: its own init, as the port's arms are). The outcome is
written either way, with the f32 arms' difference, TF32 off minus on
(``tf32_off_minus_on``: Welch's interval of the IoU, seconds per fit), and
each diagnostic arm minus the bf16 arm paired by seed
(``diagnostic_minus_bf16_paired``: paired t interval).
The JSON is rewritten after every seed, with the card's name and power
limit, and a seed already in it is not run again (the study resumes); a
file of another regime is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from unet_embroidery_seg_torch import pipeline  # noqa: E402
from unet_embroidery_seg_torch import train as train_cli  # noqa: E402
from unet_embroidery_seg_torch.data.sources import (  # noqa: E402
    SyntheticSource,
    VOCSource,
    open_source,
)
from unet_embroidery_seg_torch.utils.device import card_line, resolve_device  # noqa: E402

CONFIG = "no-ai"
SPLITS = {"train": 64, "validation": 16, "test": 16}  # export_parity_dataset.py's defaults
DATA_SEED = 0
REGIME = {"epochs": 40, "input_size": 256, "batch": 8}  # PARITY_MATCHED_INIT.json "regime"

# Test IoU bands, mean, std, n. resnet50 + Lovasz: PARITY.md:147-153
# (40 epochs, 256^2); unet_plain + BCE: PARITY.md:56-61 (the converged regime).
BANDS = {
    "resnet_lovasz": {"ref": (0.2987, 0.0414, 8), "jax_bf16": (0.3107, 0.0348, 8),
                      "jax_f32": (0.2885, 0.0509, 4)},
    "plain_bce": {"ref": (0.3880, 0.0511, 3), "jax_bf16": (0.3741, 0.0488, 3)},
}
# The JAX package's unpaired runs (its own init, as the port's arms are):
# resnet50 + Lovasz bf16 PARITY.md:61, f32 PARITY.md:101; unet_plain's JAX
# band above is already unpaired. Recorded beside each arm, not in its pass.
UNPAIRED_BANDS = {
    "resnet_lovasz": {"jax_bf16": (0.2666, 0.0352, 3), "jax_f32": (0.265, 0.057, 3)},
    "plain_bce": {"jax_bf16": (0.3741, 0.0488, 3)},
}


@dataclass(frozen=True)
class Arm:
    model: str
    loss: str
    amp: bool
    cudnn_tf32: bool | None  # under --no-amp: the CLI's setting (True) or off; None in bf16
    seeds: range
    host_input: bool = False  # --no-device-augment: PIL augmentation per sample on the host
    # conv biases drawn as torch's default (U(+-1/sqrt(fan_in))), which the
    # reference's weights_init leaves as they are; the CLI's init zeroes them
    torch_conv_bias: bool = False


ARMS = {
    "resnet_lovasz/bf16": Arm("unet_resnet50", "lovasz_hinge", True, None, range(8)),
    "resnet_lovasz/f32_tf32": Arm("unet_resnet50", "lovasz_hinge", False, True, range(8)),
    "resnet_lovasz/f32_no_tf32": Arm("unet_resnet50", "lovasz_hinge", False, False, range(8)),
    "plain_bce/bf16": Arm("unet_plain", "bce", True, None, range(3)),
}
DEFAULT_ARMS = list(ARMS)
ARMS |= {
    "resnet_lovasz/bf16_host_input": Arm("unet_resnet50", "lovasz_hinge", True, None, range(8),
                                         host_input=True),
    "resnet_lovasz/bf16_torch_conv_bias": Arm("unet_resnet50", "lovasz_hinge", True, None,
                                              range(8), torch_conv_bias=True),
}
METRIC_KEYS = ("IoU", "Dice", "Precision", "Recall", "Accuracy", "Loss")


def has_datasets() -> bool:
    try:
        import datasets  # noqa: F401
    except ImportError:
        return False
    return True


def write_parquet_tree(root: Path, sizes: dict = SPLITS, seed: int = DATA_SEED) -> None:
    """``export_parity_dataset.py``'s tree, ``{root}/no-ai/{split}/data.parquet``, from the
    port's ``SyntheticSource``."""
    import io

    from datasets import Dataset, Features, Image as HFImage, Value

    features = Features({"image": HFImage(), "mask": HFImage(), "label": Value("string"),
                         "filename": Value("string")})
    for split, n in sizes.items():
        source = SyntheticSource(split=split, length=n, seed=seed)
        data = {"image": [], "mask": [], "label": [], "filename": []}
        for i in range(n):
            s = source[i]
            for key in ("image", "mask"):
                buf = io.BytesIO()
                s[key].save(buf, format="PNG")
                data[key].append({"bytes": buf.getvalue(), "path": None})
            data["label"].append(s["label"])
            data["filename"].append(s["filename"])
        split_dir = root / CONFIG / split
        split_dir.mkdir(parents=True, exist_ok=True)
        Dataset.from_dict(data, features=features).to_parquet(str(split_dir / "data.parquet"))


def write_voc_tree(root: Path, sizes: dict = SPLITS, seed: int = DATA_SEED) -> None:
    """The same samples as a VOC tree: PNG images and masks, one id list per split."""
    voc = root / "VOC2012"
    lists, images, masks = (voc / "ImageSets" / "Segmentation", voc / "JPEGImages",
                            voc / "SegmentationClass")
    for d in (lists, images, masks):
        d.mkdir(parents=True, exist_ok=True)
    for split, n in sizes.items():
        source = SyntheticSource(split=split, length=n, seed=seed)
        ids = [f"{split}_{i:04d}" for i in range(n)]
        for i, name in enumerate(ids):
            s = source[i]
            s["image"].save(images / f"{name}.png")
            s["mask"].save(masks / f"{name}.png")
        (lists / VOCSource.SPLIT_TXT[split]).write_text("\n".join(ids) + "\n", encoding="utf-8")


def tree_format(root: Path) -> str | None:
    """``parquet`` or ``voc`` when a whole tree is at ``root``, else None."""
    if all((root / CONFIG / s / "data.parquet").is_file() for s in SPLITS):
        return "parquet"
    lists = root / "VOC2012" / "ImageSets" / "Segmentation"
    if all((lists / VOCSource.SPLIT_TXT[s]).is_file() for s in SPLITS):
        return "voc"
    return None


def ensure_tree(root: Path, fmt: str = "auto") -> str:
    """Write the study's tree at ``root`` unless one is there; returns its format.

    Then opens every split through ``open_source``, as the train CLI does,
    and raises unless each is the tree's (not the synthetic fallback) with
    the study's sample count.
    """
    found = tree_format(root)
    if found is None:
        if root.exists() and any(root.iterdir()):
            raise RuntimeError(f"{root} holds files but no whole tree of the study: "
                               "pass an empty or new --data directory")
        found = ("parquet" if has_datasets() else "voc") if fmt == "auto" else fmt
        (write_parquet_tree if found == "parquet" else write_voc_tree)(root)
    elif fmt not in ("auto", found):
        raise RuntimeError(f"{root} holds a {found} tree, not {fmt}")
    for split, n in SPLITS.items():
        source = open_source(str(root), CONFIG, split, cache_dir=str(root / ".cache"))
        if isinstance(source, SyntheticSource) or len(source) != n:
            raise RuntimeError(f"{root}: split {split} opened as {type(source).__name__} of "
                               f"{len(source)} samples, not the study's tree of {n}")
    return found


@contextlib.contextmanager
def cudnn_tf32(on: bool | None):
    """The fit's float32 precision: the CLI's (``on`` None or True), or cuDNN's TF32 off.

    Off replaces the train CLI's ``set_float32_precision`` in this process
    for the fit, and restores it after.
    """
    if on is None or on:
        yield
        return

    def f32_everywhere() -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    saved = train_cli.set_float32_precision
    train_cli.set_float32_precision = f32_everywhere
    try:
        yield
    finally:
        train_cli.set_float32_precision = saved
        saved()


def torch_conv_bias_init(model_name: str, seed: int, path: Path) -> Path:
    """The CLI's init at ``seed`` with every conv bias drawn as torch's default, saved to
    ``path``: the seed's own weights elsewhere, so the arm pairs with the CLI's."""
    from unet_embroidery_seg_torch.engine import checkpoint
    from unet_embroidery_seg_torch.models import build_model

    model = build_model(model_name, 2, diff_head=True,
                        generator=torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            bias = getattr(m, "bias", None)
            if bias is not None and m.weight.dim() == 4:  # the convs, not BN
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                bias.uniform_(-bound, bound, generator=gen)
    checkpoint.save_weights(str(path), model)
    return path


def fit_argv(arm: str, seed: int, data: Path, regime: dict, device: str,
             weights: str = "") -> list[str]:
    a = ARMS[arm]
    return (["--data-path", str(data), "--data-config", CONFIG, "--task", "binary",
             "--model", a.model, "--loss", a.loss, "--epochs", str(regime["epochs"]),
             "--batch-size", str(regime["batch"]), "--input-size", str(regime["input_size"]),
             "--seed", str(seed), "--weights", weights, "--ckpt-every", "0", "--defer-ckpt",
             "--no-export-vis", "--device", device] + ([] if a.amp else ["--no-amp"])
            + (["--no-device-augment"] if a.host_input else []))


def run_seed(arm: str, seed: int, data: Path, regime: dict, device: str) -> dict:
    """One fit of ``arm`` at ``seed``; its test metrics, best val score, seconds and settings."""
    a = ARMS[arm]
    amp = a.amp
    weights = ""
    if a.torch_conv_bias:
        weights = str(torch_conv_bias_init(a.model, seed, Path(f"init_{a.model}_{seed}.pth")))
    t0 = time.perf_counter()
    with cudnn_tf32(a.cudnn_tf32):
        exp = pipeline.run_fit(fit_argv(arm, seed, data, regime, device, weights))
        cudnn_tf32_in_fit = torch.backends.cudnn.allow_tf32
    seconds = time.perf_counter() - t0
    exp = Path(exp)
    config = json.loads((exp / "config.json").read_text(encoding="utf-8"))
    summary = json.loads((exp / "summary.json").read_text(encoding="utf-8"))
    test_path = exp / "test_metrics.json"
    if not test_path.exists():
        raise RuntimeError(f"{arm} seed {seed}: no test_metrics.json in {exp} "
                           "(test evaluation failed?)")
    if config["amp"] != amp or config["data_path"] != str(data):
        raise RuntimeError(f"{arm} seed {seed}: ran amp={config['amp']} on "
                           f"{config['data_path']}, not amp={amp} on {data}")
    test = json.loads(test_path.read_text(encoding="utf-8"))
    shutil.rmtree(exp / "weights", ignore_errors=True)  # ~100 MB a seed, not read again
    return {**{k: float(test[k]) for k in METRIC_KEYS if k in test},
            "best_val_score": float(summary["best_score"]), "seconds": seconds,
            "amp": config["amp"], "cudnn_allow_tf32": cudnn_tf32_in_fit}


def welch_ci(mean_a: float, std_a: float, n_a: int, mean_b: float, std_b: float,
             n_b: int, level: float = 0.95) -> dict:
    """Welch's ``level`` confidence interval of mean_a - mean_b from two samples' summaries."""
    from scipy import stats

    va, vb = std_a ** 2 / n_a, std_b ** 2 / n_b
    se = math.sqrt(va + vb)
    df = (va + vb) ** 2 / (va ** 2 / (n_a - 1) + vb ** 2 / (n_b - 1)) if se > 0 else math.inf
    half = float(stats.t.ppf(0.5 + level / 2, df)) * se
    diff = mean_a - mean_b
    return {"diff": diff, "lo": diff - half, "hi": diff + half, "df": df,
            "covers_zero": diff - half <= 0.0 <= diff + half}


def paired_ci(a: list[float], b: list[float], level: float = 0.95) -> dict:
    """The paired t ``level`` confidence interval of mean(a - b) over matched runs."""
    from scipy import stats

    diffs = [x - y for x, y in zip(a, b, strict=True)]
    mean, n = statistics.mean(diffs), len(diffs)
    half = float(stats.t.ppf(0.5 + level / 2, n - 1)) * statistics.stdev(diffs) / math.sqrt(n)
    return {"diff": mean, "lo": mean - half, "hi": mean + half, "n": n,
            "covers_zero": mean - half <= 0.0 <= mean + half}


def band_verdict(mean: float, std: float, n: int, band: tuple) -> dict:
    """Whether ``mean`` lies within one std of ``band``, with Welch's 95% CI of the
    difference where the arm has two runs or more."""
    b_mean, b_std, b_n = band
    verdict = {"mean": b_mean, "std": b_std, "n": b_n,
               "within_one_std": abs(mean - b_mean) <= b_std}
    if n > 1:
        verdict["welch_95"] = welch_ci(mean, std, n, b_mean, b_std, b_n)
    return verdict


def summarize(arm: str, entry: dict) -> dict:
    """The arm's IoU mean +- std over its seeds, each band's verdict and the arm's."""
    a = ARMS[arm]
    amp = a.amp
    ious = [entry["by_seed"][s]["IoU"] for s in sorted(entry["by_seed"], key=int)]
    out = {"model": a.model, "loss": a.loss, "amp": amp, "cudnn_allow_tf32": a.cudnn_tf32,
           "input_path": "host" if a.host_input else "device-resident",
           "conv_bias_init": "torch default" if a.torch_conv_bias else "zero",
           "seeds": sorted(int(s) for s in entry["by_seed"]), "by_seed": entry["by_seed"]}
    if not ious:
        return out
    mean = statistics.mean(ious)
    std = statistics.stdev(ious) if len(ious) > 1 else 0.0
    out["IoU"] = {"mean": mean, "std": std, "n": len(ious), "runs": ious}
    config = arm.split("/")[0]
    jax = "jax_bf16" if amp else "jax_f32"
    held, ok = {}, True
    for name in ("ref", jax):
        verdict = held[name] = band_verdict(mean, std, len(ious), BANDS[config][name])
        ok = ok and verdict["within_one_std"]
        if not amp and name == "ref" and "welch_95" in verdict:
            ok = ok and verdict["welch_95"]["covers_zero"]
    out["held_against"] = held
    out["pass"] = ok
    if jax in UNPAIRED_BANDS[config]:
        out["jax_unpaired"] = band_verdict(mean, std, len(ious), UNPAIRED_BANDS[config][jax])
    return out


def tf32_effect(arms: dict) -> dict | None:
    """The f32 arms' difference, cuDNN TF32 off minus on: Welch's 95% CI of the test IoU and
    the mean seconds per fit of each (None until both have two seeds)."""
    on, off = (arms.get(f"resnet_lovasz/{k}", {}) for k in ("f32_tf32", "f32_no_tf32"))
    if on.get("IoU", {}).get("n", 0) < 2 or off.get("IoU", {}).get("n", 0) < 2:
        return None
    a, b = off["IoU"], on["IoU"]
    return {"iou": welch_ci(a["mean"], a["std"], a["n"], b["mean"], b["std"], b["n"]),
            "seconds_per_fit": {name: statistics.mean(r["seconds"] for r in e["by_seed"].values())
                                for name, e in (("tf32_on", on), ("tf32_off", off))}}


def diagnostics_vs_bf16(arms: dict) -> dict:
    """Each diagnostic arm minus the bf16 arm, paired by seed (the same init but for
    what the arm changes): the paired t 95% CI of the test IoU, over the common seeds."""
    base = arms.get("resnet_lovasz/bf16", {}).get("by_seed", {})
    out = {}
    for name in ("bf16_host_input", "bf16_torch_conv_bias"):
        runs = arms.get(f"resnet_lovasz/{name}", {}).get("by_seed", {})
        seeds = sorted(set(runs) & set(base), key=int)
        if len(seeds) > 1:
            out[name] = paired_ci([runs[s]["IoU"] for s in seeds],
                                  [base[s]["IoU"] for s in seeds])
    return out


def load_results(out: Path, regime: dict) -> dict:
    if not out.exists():
        return {"regime": regime, "arms": {}}
    results = json.loads(out.read_text(encoding="utf-8"))
    if results.get("regime") != regime:
        raise SystemExit(f"{out} holds another regime ({results.get('regime')}); "
                         f"pass another --out for {regime}")
    return results


def write_results(out: Path, results: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(results, indent=1), encoding="utf-8")
    tmp.replace(out)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arms", nargs="+", default=DEFAULT_ARMS, choices=list(ARMS),
                   help="default: every arm but the two diagnostic ones")
    p.add_argument("--seeds", nargs="+", type=int, default=None,
                   help="seeds of every arm (default: each arm's own)")
    p.add_argument("--epochs", type=int, default=REGIME["epochs"])
    p.add_argument("--input-size", type=int, default=REGIME["input_size"])
    p.add_argument("--data", default=str(REPO / "build" / "parity_ds"))
    p.add_argument("--workdir", default=str(REPO / "build" / "torch_parity_runs"),
                   help="working directory of the fits (their run/train/expN)")
    p.add_argument("--out", default=str(REPO / "TORCH_PARITY.json"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    # The tree is local: the datasets library is told not to look for a hub.
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    data, out, workdir = (Path(args.data).resolve(), Path(args.out).resolve(),
                          Path(args.workdir).resolve())
    regime = {**REGIME, "epochs": args.epochs, "input_size": args.input_size}
    fmt = ensure_tree(data)
    results = load_results(out, regime)
    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for arm in args.arms:
            entry = results["arms"].setdefault(arm, {"by_seed": {}})
            for seed in args.seeds if args.seeds is not None else ARMS[arm].seeds:
                if str(seed) in entry["by_seed"]:
                    print(f"[skip] {arm} seed {seed}: in {out}", flush=True)
                    continue
                # the device of the runs: set by a call that runs one, kept by one that resumes
                results.update(card=card_line() if args.device != "cpu" else "cpu",
                               device=args.device,
                               data={"splits": SPLITS, "seed": DATA_SEED, "config": CONFIG,
                                     "format": fmt, "source": "SyntheticSource"})
                print(f"[study] {arm} seed {seed}", flush=True)
                entry["by_seed"][str(seed)] = run_seed(arm, seed, data, regime, args.device)
                results["arms"][arm] = entry = summarize(arm, entry)
                write_results(out, results)
                print(f"[study] {arm} seed {seed}: {entry['by_seed'][str(seed)]}", flush=True)
            results["arms"][arm] = summarize(arm, entry)
        effect = tf32_effect(results["arms"])
        if effect is not None:
            results["tf32_off_minus_on"] = effect
        paired = diagnostics_vs_bf16(results["arms"])
        if paired:
            results["diagnostic_minus_bf16_paired"] = paired
        write_results(out, results)
    finally:
        os.chdir(cwd)
    for arm, entry in results["arms"].items():
        if "IoU" in entry:
            iou = entry["IoU"]
            print(f"{arm}: IoU {iou['mean']:.4f} +- {iou['std']:.4f} (n={iou['n']}) "
                  f"pass={entry.get('pass')}", flush=True)
    return results


if __name__ == "__main__":
    main()
