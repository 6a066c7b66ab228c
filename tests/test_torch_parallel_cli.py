"""The train CLI on 2 ranks on the CPU (``--device cpu --mesh-data 2``) against 1 process.

unet_resnet50, binary BCE with the auto ``pos_weight``, 64^2, global batch
2 (one row per rank), 4 synthetic samples per split, f32. Runs, each in a
fresh working directory of one module directory: 1 process and 2 ranks on
the host input path for two epochs; 2 ranks for one epoch and its
``--resume`` to two; 1 process and 2 ranks on the device-resident path
(``--device-augment``). The ranks are worker processes the CLI starts
itself (spawn, gloo). Each run's checkpoints are deleted once read (the
first run's once the resumed run has read them: it restores
``resume.pth`` and copies ``best.pth`` and ``last.pth``), and the module's
directory at its end, so the checkpoints do not pile up on disk.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val
from unet_embroidery_seg_torch.models import build_model

ARGS = ["--data-path", "synthetic:4", "--input-size", "64", "--batch-size", "2",
        "--max-train-batches", "2", "--max-val-batches", "2", "--max-test-batches", "2",
        "--device", "cpu", "--no-amp", "--ckpt-every", "1", "--loss", "bce", "--vis-num", "2",
        "--pos-weight-samples", "4"]
RUNS = {  # name -> extra flags
    "one": ["--epochs", "2"],
    "two": ["--epochs", "2", "--mesh-data", "2"],
    "two_first": ["--epochs", "1", "--mesh-data", "2"],
    "resident_one": ["--epochs", "2", "--device-augment"],
    "resident_two": ["--epochs", "2", "--device-augment", "--mesh-data", "2"],
}


def _files(exp: str) -> set[str]:
    return {os.path.relpath(os.path.join(d, f), exp) for d, _, fs in os.walk(exp) for f in fs}


# A first run's checkpoints, which its --resume run reads.
FIRST_RUN_FILES = ("resume.pth", "best.pth", "last.pth")


def _delete_checkpoints(weights: str, keep: tuple[str, ...] = ()) -> None:
    for name in os.listdir(weights):
        if name.endswith(".pth") and name not in keep:
            os.remove(os.path.join(weights, name))


def _read(exp: str, keep: tuple[str, ...] = ()) -> dict:
    """What the tests read of a run; then its checkpoints are deleted, but those in ``keep``."""
    def js(name):
        with open(os.path.join(exp, name)) as f:
            return json.load(f)

    weights = os.path.join(exp, "weights")
    out = {"exp": exp, "files": _files(exp), "history": js("val_metrics_history.json"),
           "test": js("test_metrics.json"), "config": js("config.json"),
           "last": torch.load(os.path.join(weights, "last.pth"), weights_only=True),
           "best": torch.load(os.path.join(weights, "best.pth"), weights_only=True),
           "runs": sorted(os.listdir(os.path.dirname(exp)))}
    _delete_checkpoints(weights, keep)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> what the run wrote (read back), each run from a fresh working directory."""
    threads, cwd = torch.get_num_threads(), os.getcwd()
    root = tmp_path_factory.mktemp("parallel_cli")
    torch.set_num_threads(2)  # the 2-rank runs give each rank one
    out = {}
    try:
        for name, flags in RUNS.items():
            os.chdir(root)
            os.makedirs(name)
            os.chdir(name)
            first = name == "two_first"
            out[name] = _read(port_train.train(port_train.parse_args(ARGS + flags)),
                              keep=FIRST_RUN_FILES if first else ())
            if first:  # its --resume run at once, so that its checkpoints go at once
                weights = os.path.join(out[name]["exp"], "weights")
                out["two_resumed"] = _read(port_train.train(port_train.parse_args(
                    ARGS + RUNS["two"] + ["--resume", os.path.join(weights, "resume.pth")])))
                _delete_checkpoints(weights)
        yield out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", ["two", "resident_two"])
def test_two_ranks_write_one_exp_with_the_one_process_files(runs, name):
    one = runs["resident_one" if name.startswith("resident") else "one"]
    assert runs[name]["runs"] == ["exp"]
    assert runs[name]["files"] == one["files"]
    assert runs[name]["config"]["mesh_data"] == 2
    assert runs[name]["config"]["resolved_pos_weight"] == one["config"]["resolved_pos_weight"]


@pytest.mark.parametrize("name", ["two", "resident_two"])
def test_two_rank_metrics_match_one_process(runs, name):
    # f32, sum orders apart. The losses agree to 1e-4 relative over both
    # epochs of Adam (its sign-like first update moves weights whose gradient
    # is rounding noise by +-lr). The count-based metrics agree after the
    # first epoch and on the test split (best.pth is epoch 1's); after the
    # second, this barely trained model predicts most pixels within rounding
    # of logit 0, and such flips move Recall by up to ~3% (measured), so
    # only the loss is held there.
    one = runs["resident_one" if name.startswith("resident") else "one"]
    two = runs[name]
    assert len(two["history"]) == len(one["history"]) == 2
    for i, (got, want) in enumerate([*zip(two["history"], one["history"]),
                                     (two["test"], one["test"])]):
        assert got.keys() == want.keys()
        assert got["Loss"] == pytest.approx(want["Loss"], rel=1e-4)
        if i != 1:
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_checkpoints_hold_the_model_keys_and_load_strictly(runs, tmp_path):
    best = runs["two"]["best"]
    assert not [k for k in best if k.startswith("module.")]
    model = build_model("unet_resnet50", 2, device="cpu")
    assert model.load_state_dict(best, strict=True)
    assert best.keys() == runs["one"]["best"].keys()
    # through the JAX package's import (the reverse of utils/interop.py's map)
    jmodel = jax_build_model("unet_resnet50", num_classes=2)
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)), train=False))
    imported = torch_interop.import_state_dict(
        "unet_resnet50", jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(variables)),
        {k: v.numpy() for k, v in best.items()})
    assert jax.tree.structure(imported) == jax.tree.structure(dict(variables))
    # and the val CLI (one process) loads it, printing the test split's metrics
    path = str(tmp_path / "best.pth")
    torch.save(best, path)
    try:
        metrics = port_val.val(port_val.parse_args([
            "--data-path", "synthetic:4", "--input-size", "64", "--device", "cpu", "--no-amp",
            "--loss", "bce", "--weights", path]))
    finally:
        os.remove(path)
    assert set(metrics) >= {"Dice", "IoU", "Precision", "Recall", "Accuracy"}


def test_resume_under_two_ranks_continues_the_run(runs):
    full, resumed = runs["two"], runs["two_resumed"]
    assert full["last"].keys() == resumed["last"].keys()
    for k, v in full["last"].items():
        torch.testing.assert_close(resumed["last"][k], v, rtol=0, atol=0, msg=k)
    assert resumed["history"] == full["history"]


def test_a_batch_that_does_not_divide_the_data_axis_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = port_train.parse_args(ARGS + ["--batch-size", "3", "--mesh-data", "2"])
    with pytest.raises(ValueError, match="must divide the data axis"):
        port_train.train(args)
    assert not os.path.exists("run")  # refused before any artefact


def test_the_data_axis_defaults_to_one_process_on_the_cpu():
    args = port_train.parse_args(ARGS)
    assert port_train.resolve_mesh_data(args, torch.device("cpu")) == 1
