"""The paper pipeline on the port (counterpart of the repo-root ``run.sh``).

``python -m unet_embroidery_seg_torch.pipeline [run.sh's flags] [--device cuda|cpu]``

``run.sh``'s flags, defaults, stages and choices, each fit through the
port's train CLI (``unet_embroidery_seg_torch.train``) in this process:

1. loss comparison: the compare model (``--model``, default
   unet_resnet50) with both losses of the task (binary ``bce`` /
   ``lovasz_hinge``, multiclass ``ce`` / ``focal``);
2. the winner by ``summary.json``'s ``best_score``: loss b if its score is
   at least loss a's (a tie goes to b), else loss a;
3. model comparison: unet_plain, unet_resnet50, attention_unet and
   dualdense_unet at the winning loss;
4. attention ablation: unet_plain and attention_unet at both losses;

then ``scripts/make_tables.py`` (standard library only, unchanged) renders
``run/tables/*.csv`` for whatever ran; ``--max-stage N`` stops after stage N.
``--task multitask`` is one multitask_unet fit with ``bce`` and no tables,
as in ``run.sh``. Every fit's argv is the one ``run.sh`` passes to the JAX
CLI, token for token (``--no-amp`` included: one compute dtype, f32, across
every compared run), plus ``--device``. Artifacts go under the working
directory (``run/train/expN``, ``run/tables``), as ``run.sh``'s do.

There is no hub download: a ``--data-path`` that is not ``synthetic*`` and
lacks the ``--data-config`` folder is replaced by ``synthetic`` with
``run.sh``'s offline warning; ``--hf-repo`` and ``--python`` are accepted
and have no effect. ``run.sh`` itself stays the JAX pipeline.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import torch

from unet_embroidery_seg_torch import train as train_cli
from unet_embroidery_seg_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKE_TABLES = os.path.join(REPO, "scripts", "make_tables.py")
MODEL_COMPARE = ("unet_plain", "unet_resnet50", "attention_unet", "dualdense_unet")
ABLATION_MODELS = ("unet_plain", "attention_unet")
LOSSES = {"binary": ("bce", "lovasz_hinge"), "multiclass": ("ce", "focal")}
DEFAULT_COMPARE_MODEL = "unet_resnet50"


def losses_for(task: str) -> tuple[str, str]:
    """The task's loss pair (a, b): bce/lovasz_hinge are binary-only, so multiclass compares
    ce and focal (``run.sh``: two CE runs would be mislabelled as different losses)."""
    return LOSSES.get(task, LOSSES["binary"])


def winner(loss_a: str, loss_b: str, score_a: float, score_b: float) -> str:
    """``run.sh``'s stage 2: loss b if its validation best_score is at least loss a's."""
    return loss_b if float(score_b) >= float(score_a) else loss_a


def plan(task: str, max_stage: int = 4, model: str | None = None,
         winning_loss: str | None = None) -> list[tuple[str, str]]:
    """The (model, loss) fits in ``run.sh``'s order for ``task``, up to stage ``max_stage``.

    Stage 1 always runs (as in ``run.sh``); stages 3 and 4 follow the
    stage-2 winner, ``winning_loss``, which they need. multitask: one
    multitask_unet fit with bce, whatever the other arguments say.
    """
    if task == "multitask":
        return [("multitask_unet", "bce")]
    loss_a, loss_b = losses_for(task)
    compare = model or DEFAULT_COMPARE_MODEL
    fits = [(compare, loss_a), (compare, loss_b)]
    if max_stage >= 3:
        if winning_loss not in (loss_a, loss_b):
            raise ValueError(f"stage 3 needs the stage-2 winner, one of {loss_a}, {loss_b}; "
                             f"got {winning_loss!r}")
        fits += [(m, winning_loss) for m in MODEL_COMPARE]
    if max_stage >= 4:
        fits += [(m, loss) for loss in (loss_a, loss_b) for m in ABLATION_MODELS]
    return fits


def fit_argv(args, model: str, loss: str) -> list[str]:
    """The train CLI's argv for one fit: ``run.sh``'s train.py argv, then ``--device``."""
    cap = str(args.max_batches)
    return ["--task", args.task, "--data-config", args.data_config,
            "--data-path", args.data_path,
            "--model", model, "--loss", loss, "--weights", args.weights, "--no-amp",
            "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
            "--input-size", str(args.input_size),
            "--workers", str(args.workers), "--seed", str(args.seed),
            "--cache-dir", args.cache_dir,
            "--max-train-batches", cap, "--max-val-batches", cap, "--max-test-batches", cap,
            "--device", args.device]


def free_device_memory() -> None:
    """Drop the last fit's tensors and release the card's cached blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_fit(argv: list[str]) -> str:
    """One fit of the train CLI in this process; returns its ``expN``.

    Each fit seeds every generator from its ``--seed`` and builds its own
    model, optimizer and data; the kernels' packed-weight cache keys on the
    parameters' identity and version and drops a parameter's entry with it.
    The card's memory is freed after the fit, so fits do not inherit state.
    """
    try:
        return train_cli.train(train_cli.parse_args(argv))
    finally:
        free_device_memory()


def read_best_score(exp: str) -> float:
    """``summary.json``'s best_score (-1.0 when missing, as ``run.sh`` reads it)."""
    with open(os.path.join(exp, "summary.json"), encoding="utf-8") as f:
        return float(json.load(f).get("best_score", -1.0))


def banner(text: str) -> None:
    print(f"\n==============================\n{text}\n==============================", flush=True)


def resolve_data_path(args) -> str:
    """``--data-path`` (default ``--hf-local-dir``), or ``synthetic`` where the tree is missing.

    ``run.sh`` would try the hub here; offline it warns and takes the
    synthetic source. No download is made: the same warning, the same choice.
    """
    path = args.data_path or args.hf_local_dir
    if path.startswith("synthetic") or os.path.isdir(os.path.join(path, args.data_config)):
        return path
    banner(f"dataset missing ({path}/{args.data_config}): no hub download is made")
    print("[WARN] download failed (offline?); switching to the synthetic source")
    return "synthetic"


@contextlib.contextmanager
def _run_sh_environment(args):
    """``run.sh``'s folders and cache variables for the fits, restored after them."""
    for d in (args.cache_dir, ".hf-cache", ".mpl-cache", "run/train", "run/tables"):
        os.makedirs(d, exist_ok=True)
    saved = {k: os.environ.get(k) for k in ("HF_HOME", "HF_DATASETS_CACHE", "MPLCONFIGDIR")}
    os.environ.update(HF_HOME=".hf-cache", HF_DATASETS_CACHE=args.cache_dir,
                      MPLCONFIGDIR=".mpl-cache")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def render_tables(args) -> None:
    banner("tables")
    subprocess.run([sys.executable, MAKE_TABLES, "--data-config", args.data_config,
                    "--task", args.task], check=True)
    print("pipeline complete: run/train/exp*/ + run/tables/", flush=True)


def run_pipeline(args) -> list[dict]:
    """Every stage ``args`` ask for; returns one record per fit, in order.

    A record holds the fit's model, loss, ``expN``, best_score and wall
    seconds. A failing fit raises: the pipeline stops there.
    """
    resolve_device(args.device)
    records: list[dict] = []

    def fit(model: str, loss: str) -> float:
        banner(f"train: task={args.task} model={model} loss={loss} data={args.data_config}")
        t0 = time.perf_counter()
        exp = run_fit(fit_argv(args, model, loss))
        seconds = time.perf_counter() - t0
        score = read_best_score(exp)
        records.append({"model": model, "loss": loss, "exp": exp, "best_score": score,
                        "seconds": seconds})
        print(f"saved: {exp}", flush=True)
        return score

    print(f"python={sys.executable} data={args.data_config} task={args.task} "
          f"epochs={args.epochs} batch={args.batch_size} size={args.input_size}")
    for flag in ("hf_repo", "python"):
        if getattr(args, flag) is not None:
            print(f"[INFO] --{flag.replace('_', '-')} has no effect here: no hub download is "
                  "made and every fit runs in this process")
    args.data_path = resolve_data_path(args)
    with _run_sh_environment(args):
        if args.task == "multitask":
            if args.model and args.model != "multitask_unet":
                print(f"[WARN] --model {args.model} ignored for --task multitask "
                      "(multitask_unet required)")
            fit(*plan("multitask")[0])
            print("done (multitask is a single run).")
            return records
        fits = plan(args.task, 1, args.model)
        (model, loss_a), (_, loss_b) = fits
        val_a = fit(model, loss_a)
        val_b = fit(model, loss_b)
        print(f"val best_score: {loss_a}={val_a} {loss_b}={val_b}")
        if args.max_stage >= 2:
            best = winner(loss_a, loss_b, val_a, val_b)
            banner(f"best loss by val score: {best}")
            if args.max_stage >= 3:
                for stage_model, stage_loss in plan(args.task, args.max_stage, args.model,
                                                    best)[2:]:
                    fit(stage_model, stage_loss)
        render_tables(args)
    return records


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The paper pipeline (run.sh's stages) on the port")
    p.add_argument("--data-config", default="no-ai", choices=["no-ai", "full", "sam3"])
    p.add_argument("--task", default="binary", choices=["binary", "multiclass", "multitask"])
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--input-size", default=512, type=int)
    p.add_argument("--workers", default=4, type=int)
    p.add_argument("--seed", default=11, type=int)
    p.add_argument("--weights", default="")
    p.add_argument("--cache-dir", default=".hf-cache/datasets")
    p.add_argument("--data-path", default="",
                   help="DIR or synthetic[:N] (default: --hf-local-dir)")
    p.add_argument("--hf-local-dir", default="hf_datasets/merged_dataset_v2")
    p.add_argument("--max-batches", default=0, type=int,
                   help="cap train/val/test batches (smoke runs); 0: no cap")
    p.add_argument("--max-stage", default=4, type=int,
                   help="stop after stage N (1=loss compare, 2=+winner pick, 3=+model "
                        "compare, 4=all); tables render for whatever ran")
    p.add_argument("--model", default="", help="override the loss-compare model")
    p.add_argument("--device", default="cuda",
                   help="torch device of every fit; cuda raises without a card")
    p.add_argument("--hf-repo", default=None, help="accepted for run.sh's sake; no effect")
    p.add_argument("--python", default=None, help="accepted for run.sh's sake; no effect")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run_pipeline(parse_args(argv))


if __name__ == "__main__":
    main()
