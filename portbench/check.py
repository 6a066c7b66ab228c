"""The numbers that decide ``correct``: the program's readings against the reference's.

Training (``train_gaps``), of the first three steps:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient as Adam takes it, relative to
  the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same for the norm of each leaf's change over the
  three steps, leaving out the leaves whose raw first gradient in the
  reference is under a thousandth of the median leaf's (they move under
  Adam by round-off alone);
- ``loss_gap_step1``: the first step's alone; ``grad_gap_median_leaf``: the
  median leaf's gap instead of the largest;
- ``grad_diff_median_leaf``: the median leaf's norm of the difference of the
  first gradients (not the gap of their norms); ``head_grad_diff``: that of
  the class head's weight (the configuration's ``head``), whose first
  gradient is made of forward quantities only (features and the loss's
  gradient), so a seed's backward does not amplify its rounding.

Prediction (``predict_gaps``), over every pixel and class of the sampled
calls: ``prob_gap``, the largest absolute gap of a probability,
``prob_gap_mean``, its mean, ``image_gap``, the largest of one image's
mean; a call whose output has another shape than the reference's, or is
not finite, reads infinity.

``<number>_ratio`` (``with_ratios``) is a number over the witness's on the
same seed. A number passes when it is finite and not above its limit (the
cell's ``limits``); the limits and the readings they were set from are in
``PERF.md``.
"""

from __future__ import annotations

import math

import numpy as np

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's raw first-gradient norm
INFINITE_PREDICT = {"prob_gap": math.inf, "prob_gap_mean": math.inf, "image_gap": math.inf}


def _leaf_gap(got: dict[str, float], want: dict[str, float], keys) -> tuple[float, str]:
    keys = list(keys)
    median = float(np.median([want[k] for k in keys]))
    worst, name = 0.0, ""
    for k in keys:
        gap = abs(got.get(k, math.nan) - want[k]) / max(want[k], median, 1e-30)
        if not gap <= worst:  # NaN counts as the worst
            worst, name = gap, k
    return worst, name


def _median_leaf_gap(got: dict[str, float], want: dict[str, float], keys) -> float:
    keys = list(keys)
    median = float(np.median([want[k] for k in keys]))
    return float(np.median([abs(got.get(k, math.nan) - want[k]) / max(want[k], median, 1e-30)
                            for k in keys]))


def _median_leaf_diff(got: dict, want: dict) -> float:
    """The median over leaves of ||got - want|| / max(||want||, the median leaf's)."""
    norms = {k: float(w.norm()) for k, w in want.items()}
    median = float(np.median(list(norms.values())))
    return float(np.median([float((got[k].to(w.device).float() - w.float()).norm())
                            / max(norms[k], median, 1e-30) for k, w in want.items()]))


def train_gaps(got, want, head: str | None = None) -> dict[str, float]:
    per_step = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
                for a, b in zip(got.losses, want.losses)]
    grad, grad_leaf = _leaf_gap(got.grad_norms, want.grad_norms, want.grad_norms)
    raw = want.raw_grad_norms
    floor = NEGLIGIBLE_GRAD * float(np.median(list(raw.values())))
    moved = [k for k in want.change_norms if raw[k] >= floor]
    change, change_leaf = _leaf_gap(got.change_norms, want.change_norms, moved)
    return {"loss_gap": max(per_step), "grad_gap": grad, "change_gap": change,
            "loss_gap_step1": per_step[0],
            "grad_gap_median_leaf": _median_leaf_gap(got.grad_norms, want.grad_norms,
                                                     want.grad_norms),
            **_diffs(got, want, head),
            "_loss_gaps": per_step, "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": len(want.change_norms) - len(moved)}


def _diffs(got, want, head: str | None) -> dict[str, float]:
    if got.grad_vectors is None or want.grad_vectors is None:
        return {}
    out = {"grad_diff_median_leaf": _median_leaf_diff(got.grad_vectors, want.grad_vectors)}
    if head is not None:
        g, w = got.grad_vectors[head], want.grad_vectors[head]
        out["head_grad_diff"] = float((g.to(w.device).float() - w).norm()) / float(w.norm())
    return out


def predict_gaps(got: list[tuple[int, np.ndarray]], want: dict[int, np.ndarray]) -> dict:
    """Over the sampled calls: ``prob_gap``, the largest absolute gap of a probability;
    ``prob_gap_mean``, its mean; ``image_gap``, the largest of one image's mean."""
    if not got:
        return dict(INFINITE_PREDICT, _calls=0)
    worst, total, n, image_gap = 0.0, 0.0, 0, 0.0
    for b, probs in got:
        ref = want[b]
        if probs.shape != ref.shape or not np.isfinite(probs).all():
            return dict(INFINITE_PREDICT, _calls=len(got))
        gap = np.abs(probs - ref)
        worst = max(worst, float(gap.max()))
        image_gap = max(image_gap, float(gap.mean(axis=(1, 2, 3)).max()))
        total += float(gap.sum(dtype=np.float64))
        n += gap.size
    return {"prob_gap": worst, "prob_gap_mean": total / n, "image_gap": image_gap,
            "_calls": len(got)}


def with_ratios(gaps: dict, witness: dict) -> dict:
    """``gaps`` and, for each of its numbers, ``<name>_ratio``: the number over the witness's
    (the reference at the configuration's own precision in the program's place) on the same
    seed, which takes out how far the seed's weights amplify rounding."""
    out = dict(gaps)
    for k, v in gaps.items():
        if not k.startswith("_") and isinstance(v, float) and k in witness:
            w = witness[k]
            out[f"{k}_ratio"] = v / w if w > 0 else (math.inf if v > 0 else 1.0)
    return out


def verdict(gaps: dict, limits: dict[str, float]) -> tuple[bool, list[dict]]:
    """(every compared number within its limit, [{name, value, limit}] in the limits' order)."""
    rows = [{"name": k, "value": gaps[k], "limit": lim} for k, lim in limits.items()]
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows), rows
