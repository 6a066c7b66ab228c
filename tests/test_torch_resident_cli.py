"""The train and val CLIs on the device-resident path, on the CPU (``--device-augment --device cpu``).

For each task at 32^2, batch 2, on 4 synthetic samples per split: a run of
two epochs, one of one epoch and its ``--resume`` to two; the resumed run's
weights and histories equal the uninterrupted run's exactly (every random
draw comes from (seed, epoch, step)), whatever ``--scan-chunk`` splits the
epoch into. ``val.py --device-resident --batch-size 4`` prints what the
host path (batch 1) prints for the same checkpoint.

The module fixture reads the checkpoints the tests compare as soon as each
run ends and then deletes them (the first epoch's once its resumed run has
read them); the val test writes its checkpoint to its own directory and
deletes it. So the checkpoints do not pile up on disk.
"""

import json
import os
import shutil

import pytest
import torch

from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val

ARGS = ["--data-path", "synthetic:4", "--input-size", "32", "--batch-size", "2",
        "--max-train-batches", "2", "--max-val-batches", "1", "--max-test-batches", "2",
        "--device", "cpu", "--no-amp", "--ckpt-every", "1", "--vis-num", "2"]
TASKS = {
    "binary": ["--task", "binary", "--model", "unet_plain", "--loss", "bce"],
    "multiclass": ["--task", "multiclass", "--model", "unet_plain", "--loss", "ce"],
    "multitask": ["--task", "multitask", "--model", "multitask_unet", "--loss", "bce"],
}


def _load(exp: str, name: str) -> dict:
    return torch.load(os.path.join(exp, "weights", name), weights_only=True)


def _delete_checkpoints(exp: str) -> None:
    weights = os.path.join(exp, "weights")
    for name in os.listdir(weights):
        if name.endswith(".pth"):
            os.remove(os.path.join(weights, name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """task -> the full and resumed runs' exp folders, the full run's file names, both
    runs' ``last.pth`` and the full run's ``best.pth``; trained once in a module working dir,
    each run's checkpoints deleted once read (the first epoch's once its resumed run
    has read them)."""
    threads, cwd = torch.get_num_threads(), os.getcwd()
    workdir = tmp_path_factory.mktemp("resident_cli")
    torch.set_num_threads(1)
    os.chdir(workdir)
    try:
        out = {}
        for task, flags in TASKS.items():
            base = ARGS + flags + ["--device-augment"]
            full = os.path.abspath(port_train.train(port_train.parse_args(base + ["--epochs",
                                                                                  "2"])))
            out[task] = {"full": full, "names": {os.path.relpath(os.path.join(d, f), full)
                                                 for d, _, fs in os.walk(full) for f in fs},
                         "last": _load(full, "last.pth"), "best": _load(full, "best.pth")}
            _delete_checkpoints(full)
            first = port_train.train(port_train.parse_args(base + ["--epochs", "1"]))
            resumed = os.path.abspath(port_train.train(port_train.parse_args(
                base + ["--epochs", "2", "--scan-chunk", "1",
                        "--resume", os.path.join(first, "weights", "resume.pth")])))
            out[task].update(resumed=resumed,
                             last=(out[task]["last"], _load(resumed, "last.pth")))
            _delete_checkpoints(first)  # the resumed run has read them
            _delete_checkpoints(resumed)
        yield out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        shutil.rmtree(workdir, ignore_errors=True)


@pytest.mark.parametrize("task", list(TASKS))
def test_resident_resume_equals_an_uninterrupted_run(runs, task):
    full, resumed = runs[task]["full"], runs[task]["resumed"]
    a, b = runs[task]["last"]
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    for name in ("val_metrics_history.json", "summary.json"):
        ha = json.load(open(os.path.join(full, name)))
        hb = json.load(open(os.path.join(resumed, name)))
        if name == "summary.json":
            ha = {k: v for k, v in ha.items() if not k.endswith("_path")}
            hb = {k: v for k, v in hb.items() if not k.endswith("_path")}
        assert ha == hb, name


@pytest.mark.parametrize("task", list(TASKS))
def test_resident_train_cli_writes_the_artifacts(runs, task):
    full, names = runs[task]["full"], runs[task]["names"]
    want = {"config.json", "summary.json", "test_metrics.json", "val_metrics_history.json",
            "val_metrics_history.csv", "weights/best.pth", "weights/last.pth",
            "weights/resume.pth", "weights/loss_curve.png", "weights/metrics_curve.png"}
    if task != "multiclass":  # the JAX CLI writes grids for binary and multitask only
        want |= {"vis/indices.json"} | {n for n in names if n.endswith("_grid.png")}
        assert sum(n.endswith("_grid.png") for n in names) == 2
    assert names == want
    config = json.load(open(os.path.join(full, "config.json")))
    assert config["device_augment"] is True
    summary = json.load(open(os.path.join(full, "summary.json")))
    assert summary["test_metrics"] == json.load(open(os.path.join(full, "test_metrics.json")))


@pytest.mark.parametrize("task", list(TASKS))
def test_val_device_resident_prints_the_host_paths_metrics(runs, task, capsys, tmp_path):
    weights = str(tmp_path / "best.pth")
    torch.save(runs[task]["best"], weights)
    common = ["--data-path", "synthetic:4", "--input-size", "32", "--device", "cpu", "--no-amp",
              "--weights", weights] + TASKS[task]
    capsys.readouterr()
    try:
        host = port_val.val(port_val.parse_args(common))
        host_out = capsys.readouterr().out
        res = port_val.val(port_val.parse_args(common + ["--device-resident", "--batch-size",
                                                         "4"]))
        res_out = capsys.readouterr().out
    finally:
        os.remove(weights)
    assert "[cache] 4 samples" in res_out and "[cache]" not in host_out

    def report(out):  # what follows the "Starting evaluation..." line
        return out.split("Starting evaluation...")[1]

    if task == "multiclass":  # per-sample means: the losses sum in another order
        assert host.keys() == res.keys()
        for k in host:
            assert res[k] == pytest.approx(host[k], rel=1e-6, abs=1e-7), k
    else:
        assert report(res_out) == report(host_out)
        for k in host:
            if k != "Loss":  # a mean over batches of 1 against batches of 4
                assert res[k] == host[k], k


def test_the_cpu_default_is_the_host_path(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = port_train.parse_args(ARGS + TASKS["binary"] + ["--epochs", "1", "--no-export-vis"])
    assert args.device_augment is None and args.export_vis is False
    try:
        port_train.train(args)
    finally:
        shutil.rmtree(tmp_path / "run", ignore_errors=True)
    out = capsys.readouterr().out
    assert "[input] device-resident path" not in out and "[cache]" not in out
    args = port_val.parse_args(["--device", "cpu"])
    assert args.device_resident is None and args.batch_size == 8
