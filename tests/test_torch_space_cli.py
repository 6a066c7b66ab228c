"""The train CLI over the mesh's space axis on the CPU (``--mesh-data 2 --mesh-space 2``).

unet_resnet50, binary Lovasz hinge, 64^2, global batch 2 (one image per
data index, each image's rows split in two), 4 synthetic samples per split,
f32. Runs, each in a fresh working directory of one module directory: 1
process and 2x2 ranks on the host input path for two epochs; 2x2 ranks for
one epoch and its ``--resume`` to two; 1 process and 1x2 ranks on the
device-resident path (``--device-augment``) for one epoch. The ranks are
worker processes the CLI starts itself (spawn, gloo).

Then the other tasks over a 1x2 mesh (``--mesh-data 1 --mesh-space 2``),
each against one process: unet_plain multiclass (CE + Dice) on the host
input path and multitask_unet on the device-resident path (its dropout on,
seeded as one process seeds it: one data index), each for two epochs, and
one epoch of the 1x2 run and its ``--resume`` to two. multitask_unet's
metrics are held more loosely: at 64^2 and batch 2 its class head reads
BN'd 2x2 maps, and Adam's first, sign-like update turns f32 rounding into
whole steps (in one process, moving the input by one f32 ulp moved the
next step's class CE by 2.7%, and the 1x2 split by 1.4%), so a few pixels
and a class prediction of the barely trained model differ;
``tests/test_torch_space_families.py`` holds its update against a noise
floor measured in the run.

Each run's checkpoints are deleted once read (the first epoch's once the
resumed run has read them: it restores ``resume.pth`` and copies
``best.pth`` and ``last.pth``), and each module directory at its end, so
the checkpoints do not pile up on disk.
"""

import json
import os
import shutil

import pytest
import torch

from unet_embroidery_seg_torch import train as port_train

ARGS = ["--data-path", "synthetic:4", "--input-size", "64", "--batch-size", "2",
        "--max-train-batches", "2", "--max-val-batches", "2", "--max-test-batches", "2",
        "--device", "cpu", "--no-amp", "--ckpt-every", "1", "--loss", "lovasz_hinge",
        "--vis-num", "2"]
SPACE = ["--mesh-data", "2", "--mesh-space", "2"]
RUNS = {  # name -> extra flags
    "one": ["--epochs", "2"],
    "space": ["--epochs", "2", *SPACE],
    "space_first": ["--epochs", "1", *SPACE],
    "resident_one": ["--epochs", "1", "--device-augment"],
    "resident_space": ["--epochs", "1", "--device-augment", "--mesh-data", "1",
                       "--mesh-space", "2"],
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
           "runs": sorted(os.listdir(os.path.dirname(exp)))}
    _delete_checkpoints(weights, keep)
    return out


def _keep(name: str) -> tuple[str, ...]:
    return FIRST_RUN_FILES if name == "space_first" else ()


def _resume(first: str, argv: list[str]) -> dict:
    """The ``--resume`` run of the run at ``first``, read back, run at once after it (from its
    working directory) so that the first run's checkpoints go at once."""
    weights = os.path.join(first, "weights")
    out = _read(port_train.train(port_train.parse_args(
        argv + ["--resume", os.path.join(weights, "resume.pth")])))
    _delete_checkpoints(weights)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> what the run wrote (read back), each run from a fresh working directory."""
    threads, cwd = torch.get_num_threads(), os.getcwd()
    root = tmp_path_factory.mktemp("space_cli")
    torch.set_num_threads(4)  # the 2x2 runs give each rank one
    out = {}
    try:
        for name, flags in RUNS.items():
            os.chdir(root)
            os.makedirs(name)
            os.chdir(name)
            out[name] = _read(port_train.train(port_train.parse_args(ARGS + flags)),
                              keep=_keep(name))
            if name == "space_first":
                out["space_resumed"] = _resume(out[name]["exp"], ARGS + RUNS["space"])
        yield out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", ["space", "resident_space"])
def test_space_ranks_write_one_exp_with_the_one_process_files(runs, name):
    one = runs["resident_one" if name.startswith("resident") else "one"]
    assert runs[name]["runs"] == ["exp"]
    assert runs[name]["files"] == one["files"]
    assert runs[name]["config"]["mesh_space"] == 2


@pytest.mark.parametrize("name", ["space", "resident_space"])
def test_space_rank_metrics_match_one_process(runs, name):
    # f32, sum orders apart, as tests/test_torch_parallel_cli.py holds the
    # data axis: the losses to 1e-4 relative; the count-based metrics after
    # the first epoch and on the test split to 1e-6 (after a second epoch of
    # Adam this barely trained model predicts most pixels within rounding
    # of logit 0, so only the loss is held there).
    one = runs["resident_one" if name.startswith("resident") else "one"]
    got_runs = runs[name]
    assert len(got_runs["history"]) == len(one["history"])
    pairs = [*zip(got_runs["history"], one["history"]), (got_runs["test"], one["test"])]
    for i, (got, want) in enumerate(pairs):
        assert got.keys() == want.keys()
        assert got["Loss"] == pytest.approx(want["Loss"], rel=1e-4)
        if i != 1:
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_resume_over_the_space_axis_continues_the_run(runs):
    full, resumed = runs["space"], runs["space_resumed"]
    assert full["last"].keys() == resumed["last"].keys()
    for k, v in full["last"].items():
        torch.testing.assert_close(resumed["last"][k], v, rtol=0, atol=0, msg=k)
    assert resumed["history"] == full["history"]


def test_the_data_axis_defaults_to_one_on_the_cpu_with_a_space_axis():
    args = port_train.parse_args(ARGS + ["--mesh-space", "2"])
    assert port_train.resolve_mesh_data(args, torch.device("cpu")) == 1


def test_a_batch_that_does_not_divide_the_data_axis_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = port_train.parse_args(ARGS + ["--batch-size", "3", *SPACE])
    with pytest.raises(ValueError, match="must divide the data axis"):
        port_train.train(args)
    assert not os.path.exists("run")  # refused before any artefact


# --- the other tasks: unet_plain multiclass (host-fed), multitask_unet (resident) -------------

TASK_COMMON = ["--data-path", "synthetic:4", "--input-size", "64", "--batch-size", "2",
               "--max-train-batches", "2", "--max-val-batches", "1", "--max-test-batches", "1",
               "--device", "cpu", "--no-amp", "--ckpt-every", "1", "--vis-num", "1"]
TASK_FLAGS = {
    "multiclass": ["--task", "multiclass", "--model", "unet_plain", "--loss", "ce"],
    "multitask": ["--task", "multitask", "--model", "multitask_unet", "--loss", "bce",
                  "--device-augment"],
}
SPACE12 = ["--mesh-data", "1", "--mesh-space", "2"]
TASK_RUNS = {"one": ["--epochs", "2"], "space": ["--epochs", "2", *SPACE12],
             "space_first": ["--epochs", "1", *SPACE12]}


@pytest.fixture(scope="module", params=list(TASK_FLAGS))
def task_runs(request, tmp_path_factory):
    """The task's runs (one process, 1x2, 1x2 for one epoch and resumed), read back."""
    task = request.param
    threads, cwd = torch.get_num_threads(), os.getcwd()
    root = tmp_path_factory.mktemp(f"space_cli_{task}")
    torch.set_num_threads(2)  # the 1x2 runs give each rank one
    args = TASK_COMMON + TASK_FLAGS[task]
    out = {"task": task}
    try:
        for name, flags in TASK_RUNS.items():
            os.chdir(root)
            os.makedirs(name)
            os.chdir(name)
            out[name] = _read(port_train.train(port_train.parse_args(args + flags)),
                              keep=_keep(name))
            if name == "space_first":
                out["space_resumed"] = _resume(out[name]["exp"], args + TASK_RUNS["space"])
        yield out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)


def test_task_space_run_writes_one_exp_with_the_one_process_files(task_runs):
    got, one = task_runs["space"], task_runs["one"]
    assert got["runs"] == ["exp"]
    assert got["files"] == one["files"]
    assert (got["config"]["mesh_space"], got["config"]["task"]) == (2, task_runs["task"])


def test_task_space_metrics_match_one_process(task_runs):
    # multiclass, as the binary runs above: losses to 1e-4 relative, the
    # metrics after the first epoch and on the test split to 1e-6.
    # multitask: the losses to 5e-2, twice the class CE's measured floor
    # (module docstring), the metrics in their ranges.
    got_runs, one = task_runs["space"], task_runs["one"]
    multitask = task_runs["task"] == "multitask"
    assert len(got_runs["history"]) == len(one["history"]) == 2
    pairs = [*zip(got_runs["history"], one["history"]), (got_runs["test"], one["test"])]
    for i, (got, want) in enumerate(pairs):
        assert got.keys() == want.keys()
        assert got["Loss"] == pytest.approx(want["Loss"], rel=5e-2 if multitask else 1e-4)
        if multitask:
            assert 0 <= got["IoU"] <= 1 and 0 <= got["Dice"] <= 1 and 0 <= got["Cls Acc"] <= 100
        elif i != 1:
            for k, v in want.items():
                if k != "Loss":
                    assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_task_resume_over_the_space_axis_continues_the_run(task_runs):
    full, resumed = task_runs["space"], task_runs["space_resumed"]
    assert full["last"].keys() == resumed["last"].keys()
    for k, v in full["last"].items():
        torch.testing.assert_close(resumed["last"][k], v, rtol=0, atol=0, msg=k)
    assert resumed["history"] == full["history"]
