"""The seeded inputs of a run: weights, a resident split, epoch plans, predict batches.

Everything here belongs to the benchmark and is made from ``--seed``. The
program and the reference are handed the same values, and the reference
makes any of them again from the seed instead of reading what the program
holds. Each canvas has its own generator, so a few rows can be remade
without the whole split.

Work does not depend on the seed: every seed gives the same number of
canvases, the same canvas and batch shapes and the same plan lengths; the
seed moves only pixel values, content sizes inside the canvas and order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Stream ids under one seed, so that no two kinds of draw share a generator.
WEIGHTS, CANVAS_SHAPE, CANVAS_PIXELS, PLAN, PREDICT, SAMPLE, CALIBRATE = range(1, 8)
RESIDUAL_SCALE = 0.2


def subseed(seed: int, *path: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``(seed, *path)``."""
    word = np.random.SeedSequence((seed, *path)).generate_state(1, dtype=np.uint64)[0]
    return int(word >> np.uint64(1))


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *path))


def init_spec(model: torch.nn.Module) -> list[tuple[str, tuple[int, ...], str]]:
    """(state-dict key, shape, kind) of every parameter and buffer, in module order.

    Kinds: ``conv_w`` (He-normal over the fan-in), ``bias`` (N(0, 0.1)),
    ``bn_w`` (1 + N(0, 0.1)), ``bn_b`` (N(0, 0.1)), ``bn_mean`` (0),
    ``bn_var`` (1), ``count`` (0); a BN that ends a residual branch (its
    module has ``residual_end``) takes ``RESIDUAL_SCALE`` times its scale and
    bias (``bn_w_res``, ``bn_b_res``), so that each block starts near the
    identity, as trained ResNets' blocks are, and a random net does not
    amplify rounding from block to block.
    """
    spec = []
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, torch.nn.BatchNorm2d):
            res = "_res" if getattr(m, "residual_end", False) else ""
            spec += [(pre + "weight", tuple(m.weight.shape), "bn_w" + res),
                     (pre + "bias", tuple(m.bias.shape), "bn_b" + res),
                     (pre + "running_mean", tuple(m.running_mean.shape), "bn_mean"),
                     (pre + "running_var", tuple(m.running_var.shape), "bn_var"),
                     (pre + "num_batches_tracked", (), "count")]
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            spec.append((pre + "weight", tuple(m.weight.shape), "conv_w"))
            if m.bias is not None:
                spec.append((pre + "bias", tuple(m.bias.shape), "bias"))
    return spec


def weights(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of ``spec`` drawn from ``seed`` on ``device``, in one normal draw.

    He-normal conv weights keep the activations of every layer near unit
    scale in eval mode too (BN's running statistics are 0 and 1), so the
    predicted probabilities are not all one half.
    """
    sizes = [int(np.prod(shape)) for _, shape, kind in spec if kind not in ("bn_mean", "bn_var",
                                                                            "count")]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, WEIGHTS), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if kind in ("bn_mean", "bn_var"):
            out[name] = torch.full(shape, 0.0 if kind == "bn_mean" else 1.0, device=device)
            continue
        n = int(np.prod(shape))
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "conv_w":
            fan_in = n // shape[0]
            out[name] = z * (2.0 / fan_in) ** 0.5
        elif kind.startswith("bn_w"):
            out[name] = (1.0 + 0.1 * z) * (RESIDUAL_SCALE if kind.endswith("_res") else 1.0)
        else:
            out[name] = 0.1 * z * (RESIDUAL_SCALE if kind.endswith("_res") else 1.0)
    return out


CALIBRATION_IMAGES = 8


def calibrated(model: torch.nn.Module, weights: dict[str, torch.Tensor], seed: int, size: int,
               device) -> dict[str, torch.Tensor]:
    """``weights`` with every BN's running statistics set to those of a seeded batch.

    Eval-mode BN then normalises as a trained model's does, instead of
    letting activations grow with depth and size; and the class head (the
    model's last conv) is scaled so that its logits have unit RMS over the
    batch, so that the predicted probabilities are not saturated and the
    logits' own rounding to bf16 stays small. ``model`` is the plain
    reference (float32, TF32 off): one forward in train mode over
    ``CALIBRATION_IMAGES`` canvases of ``size``^2 with a cumulative average,
    then one in eval mode for the head's scale.
    """
    from portbench.reference.models import Precision

    model.load_state_dict(weights)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    x = torch.stack([_content(seed, CALIBRATE * 1_000_000 + j, size, device, False)[0]
                     for j in range(CALIBRATION_IMAGES)]).to(torch.float32) / 255.0
    model.train()
    with torch.no_grad(), Precision("f32", device):
        model(x.permute(0, 3, 1, 2))
    for m in bns:
        m.momentum = 0.1
    head = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)][-1]
    seen = {}
    hook = head.register_forward_hook(lambda m, i, o: seen.update(y=o))
    model.eval()
    with torch.no_grad(), Precision("f32", device):
        model(x.permute(0, 3, 1, 2))
    hook.remove()
    scale = seen["y"].float().pow(2).mean().sqrt()
    with torch.no_grad():
        head.weight.div_(scale)
        head.bias.div_(scale)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _content(seed: int, i: int, size: int, device, masked: bool):
    """Canvas ``i``: (image u8 (size, size, 3), mask u8 (size, size) or None, (nw, nh)).

    A random-aspect picture, letterboxed: smooth colour noise with fine
    grain, one disc of a flat colour (the mask's foreground), centred on a
    gray 128 canvas as ``data/cache.CanvasCache`` letterboxes it.
    """
    rng = np.random.default_rng((seed, CANVAS_SHAPE, i))
    w, h = (int(v) for v in rng.integers(size // 2, 2 * size, 2))
    scale = min(size / w, size / h)
    nw, nh = int(w * scale), int(h * scale)
    cx, cy = rng.uniform(0.2, 0.8, 2) * (nw, nh)
    r = rng.uniform(0.1, 0.35) * min(nw, nh)
    g = generator(device, seed, CANVAS_PIXELS, i)
    coarse = torch.rand((1, 3, 17, 17), generator=g, device=device)
    img = F.interpolate(coarse, size=(nh, nw), mode="bicubic", align_corners=False)[0]
    img = img + 0.15 * (torch.rand((3, nh, nw), generator=g, device=device) - 0.5)
    color = torch.rand((3, 1, 1), generator=g, device=device)
    yy = torch.arange(nh, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(nw, device=device, dtype=torch.float32)[None, :]
    disc = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    img = torch.where(disc, color, img).clamp(0.0, 1.0)
    canvas = torch.full((size, size, 3), 128, dtype=torch.uint8, device=device)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = (img.permute(1, 2, 0) * 255.0).round().to(torch.uint8)
    mask = None
    if masked:
        mask = torch.zeros((size, size), dtype=torch.uint8, device=device)
        mask[top:top + nh, left:left + nw] = disc.to(torch.uint8)
    return canvas, mask, (nw, nh)


def split(seed: int, n: int, size: int, device):
    """(images u8 (n, S, S, 3), masks u8 (n, S, S), valid_wh f32 (n, 2)) of a resident split."""
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    masks = torch.empty((n, size, size), dtype=torch.uint8, device=device)
    wh = []
    for i in range(n):
        images[i], masks[i], v = _content(seed, i, size, device, True)
        wh.append(v)
    return images, masks, torch.tensor(wh, dtype=torch.float32, device=device)


def split_rows(seed: int, rows, size: int, device):
    """The same as ``split`` for the canvases ``rows`` only, in that order."""
    out = [_content(seed, int(i), size, device, True) for i in rows]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.tensor([o[2] for o in out], dtype=torch.float32, device=device))


def pos_weight_rows(n: int, samples: int = 80) -> np.ndarray:
    """The canvases the BCE's ``pos_weight`` is estimated from: ``samples`` spaced evenly over
    the split (the train CLI's rule, ``train.estimate_pos_weight``)."""
    return np.linspace(0, n - 1, min(samples, n)).astype(int)


def pos_weight(masks: torch.Tensor) -> float:
    """neg / pos over the masks of ``pos_weight_rows`` (canvases, not augmented items)."""
    pos = int((masks == 1).sum())
    return (masks.numel() - pos) / pos


def plan(n: int, batch: int, epoch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(steps, B) int64 rows and (steps, B) f32 sample mask of ``epoch``: a seeded shuffle,
    the last batch padded by repeating its rows and the padding masked out."""
    order = np.random.default_rng((seed, PLAN, epoch)).permutation(n)
    steps = -(-n // batch)
    idx = np.resize(order, steps * batch).reshape(steps, batch)
    tail = n - (steps - 1) * batch
    idx[-1] = np.resize(order[(steps - 1) * batch:], batch)
    mask = np.ones((steps, batch), np.float32)
    mask[-1, tail:] = 0.0
    return idx.astype(np.int64), mask


def predict_batch(seed: int, b: int, batch: int, size: int, device) -> torch.Tensor:
    """Pool batch ``b``: (batch, S, S, 3) float32 letterboxed canvases in [0, 1], on ``device``,
    as the predict CLI's letterbox makes them (``uint8 / 255``)."""
    rows = [_content(seed, PREDICT * 1_000_000 + b * batch + j, size, device, False)[0]
            for j in range(batch)]
    return torch.stack(rows).to(torch.float32) / 255.0
