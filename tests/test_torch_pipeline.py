"""The port's paper pipeline (``unet_embroidery_seg_torch.pipeline``) against ``run.sh``.

``run.sh`` runs here with ``--python`` set to a stub: the stub runs the real
interpreter for ``-c`` snippets and ``scripts/make_tables.py``, refuses the
hub download (as an offline host does), and for ``train.py`` records its
argv and writes a ``run/train/expN`` with a ``config.json`` and a
``summary.json`` holding a set ``best_score``. So ``run.sh``'s exact fit
argv, sequence and winner show without JAX training. The port's pipeline
runs the same flags with its fits replaced by the same stub, and its argv,
sequence and tables must equal ``run.sh``'s. Then real fits on the CPU: one
pipeline to stage 1, and two fits in one process against the same argvs in
subprocesses.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from unet_embroidery_seg_torch import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    """Delete the test's ``tmp_path`` when it ends, pass or fail (it holds checkpoints)."""
    yield
    if "tmp_path" in request.fixturenames:
        shutil.rmtree(request.node.funcargs["tmp_path"], ignore_errors=True)

STUB = """#!{python}
import json, os, sys

args = sys.argv[1:]
if args[:1] == ["-c"] and "huggingface_hub" in args[1]:
    sys.exit(1)  # offline: the download fails, no host is contacted
if not (args and args[0].endswith("train.py")):
    os.execv({python!r}, [{python!r}] + args)  # -c snippets, make_tables.py
argv = args[1:]
with open(os.environ["STUB_ARGV_LOG"], "a") as f:
    f.write(json.dumps(argv) + "\\n")
opt = {{argv[i]: argv[i + 1] for i in range(len(argv) - 1) if argv[i].startswith("--")}}
n = 0
while os.path.exists(os.path.join("run", "train", "exp" + (str(n) if n else ""))):
    n += 1
exp = os.path.join("run", "train", "exp" + (str(n) if n else ""))
os.makedirs(os.path.join(exp, "weights"))
score = json.loads(os.environ["STUB_SCORES"])[opt["--loss"]]
config = {{"task": opt["--task"], "model": opt["--model"], "loss": opt["--loss"],
           "data_config": opt["--data-config"], "data_path": opt["--data-path"]}}
test = {{"IoU": score, "Dice": score, "Mean IoU": score}}
with open(os.path.join(exp, "config.json"), "w") as f:
    json.dump(config, f)
with open(os.path.join(exp, "summary.json"), "w") as f:
    json.dump({{"best_epoch": 1, "best_score": score, "test_metrics": test}}, f)
print("exp: " + exp)
"""

BASE = ["--epochs", "1", "--batch-size", "8", "--input-size", "32", "--workers", "0",
        "--seed", "5"]
SYNTH = ["--data-path", "synthetic:16", "--max-batches", "2"]

# (id, flags, scores by loss): both winner branches, a tie, every --max-stage,
# every task, the default cap (0), and a missing tree (offline fallback).
CASES = [
    ("binary-4-bce-wins", ["--task", "binary"] + SYNTH, {"bce": 0.5, "lovasz_hinge": 0.25}),
    ("binary-4-lovasz-wins", ["--task", "binary", "--model", "unet_plain"] + SYNTH,
     {"bce": 0.25, "lovasz_hinge": 0.5}),
    ("binary-3-tie", ["--task", "binary", "--max-stage", "3"] + SYNTH,
     {"bce": 0.375, "lovasz_hinge": 0.375}),
    ("binary-2", ["--task", "binary", "--max-stage", "2"] + SYNTH,
     {"bce": 0.5, "lovasz_hinge": 0.25}),
    ("binary-1-no-cap", ["--task", "binary", "--max-stage", "1", "--data-path", "synthetic"],
     {"bce": 0.5, "lovasz_hinge": 0.25}),
    ("multiclass-4-ce-wins", ["--task", "multiclass", "--model", "attention_unet"] + SYNTH,
     {"ce": 0.5, "focal": 0.25}),
    ("multiclass-1", ["--task", "multiclass", "--max-stage", "1"] + SYNTH,
     {"ce": 0.25, "focal": 0.5}),
    ("multitask", ["--task", "multitask", "--model", "unet_plain"] + SYNTH, {"bce": 0.5}),
    ("offline-fallback", ["--task", "binary", "--max-stage", "1", "--data-path", "no_such_tree",
                          "--weights", "w.pth", "--data-config", "full"],
     {"bce": 0.25, "lovasz_hinge": 0.25}),
]


def _stub(tmp_path) -> str:
    path = tmp_path / "python-stub"
    path.write_text(STUB.format(python=sys.executable))
    path.chmod(0o755)
    return str(path)


def _env(tmp_path, log, scores) -> dict:
    return {**os.environ, "STUB_ARGV_LOG": str(log), "STUB_SCORES": json.dumps(scores)}


def _read_argvs(log) -> list[list[str]]:
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def _tables(cwd) -> dict:
    out = {}
    for path in sorted(glob.glob(str(cwd / "run" / "tables" / "*.csv"))):
        with open(path, newline="", encoding="utf-8") as f:
            out[os.path.basename(path)] = list(csv.reader(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case through run.sh with the stub interpreter."""
    out, dirs = {}, []
    for name, flags, scores in CASES:
        tmp = tmp_path_factory.mktemp(name)
        dirs.append(tmp)
        stub = _stub(tmp)
        sh_dir = tmp / "run_sh"
        sh_dir.mkdir()
        res = subprocess.run(["bash", os.path.join(REPO, "run.sh"), "--python", stub] + BASE
                             + flags, cwd=sh_dir, env=_env(tmp, tmp / "sh.log", scores),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        out[name] = {"flags": flags, "scores": scores, "sh_stdout": res.stdout,
                     "sh_argvs": _read_argvs(tmp / "sh.log"), "sh_tables": _tables(sh_dir),
                     "stub": stub, "env": _env(tmp, tmp / "pipeline.log", scores)}
    yield out
    for tmp in dirs:
        shutil.rmtree(tmp, ignore_errors=True)


def _drive(case: dict, cwd, monkeypatch, capsys) -> tuple[list[dict], list[list[str]], str]:
    """The port's pipeline on the case's flags in ``cwd``, each fit the stub's; (records, fit
    argvs, stdout)."""
    argvs = []

    def stub_fit(argv):
        argvs.append(list(argv))
        res = subprocess.run([case["stub"], os.path.join(REPO, "train.py"), *argv], check=True,
                             env=case["env"], capture_output=True, text=True)
        return res.stdout.strip().split("exp: ")[-1]

    monkeypatch.chdir(cwd)
    monkeypatch.setattr(pipeline, "run_fit", stub_fit)
    records = pipeline.main(BASE + case["flags"] + ["--device", "cpu"])
    return records, argvs, capsys.readouterr().out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_fit_argv_equals_run_sh_token_for_token(runs, name, tmp_path, monkeypatch,
                                                       capsys):
    case = runs[name]
    records, argvs, _ = _drive(case, tmp_path, monkeypatch, capsys)
    assert case["sh_argvs"], "run.sh ran no fit"
    assert all(a[-2:] == ["--device", "cpu"] for a in argvs)
    assert [a[:-2] for a in argvs] == case["sh_argvs"]
    assert [(r["model"], r["loss"]) for r in records] == [
        (a[a.index("--model") + 1], a[a.index("--loss") + 1]) for a in case["sh_argvs"]]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_sequence_and_tables_equal_run_sh(runs, name, tmp_path, monkeypatch, capsys):
    case = runs[name]
    records, _, out = _drive(case, tmp_path, monkeypatch, capsys)
    flags = pipeline.parse_args(BASE + case["flags"])
    fits = [(r["model"], r["loss"]) for r in records]
    if flags.task == "multitask":
        assert fits == pipeline.plan("multitask")
        assert "ignored for --task multitask" in case["sh_stdout"]
        assert "ignored for --task multitask" in out
    else:
        a, b = pipeline.losses_for(flags.task)
        best = pipeline.winner(a, b, case["scores"][a], case["scores"][b])
        assert fits == pipeline.plan(flags.task, flags.max_stage, flags.model, best)
        if flags.max_stage >= 2:
            assert f"best loss by val score: {best}" in case["sh_stdout"]
            assert f"best loss by val score: {best}" in out
    assert _tables(tmp_path) == case["sh_tables"]
    assert bool(case["sh_tables"]) == (flags.task != "multitask")


def test_offline_fallback_warns_and_takes_synthetic(runs):
    case = runs["offline-fallback"]
    for argv in case["sh_argvs"]:
        assert argv[argv.index("--data-path") + 1] == "synthetic"
    assert "switching to the synthetic source" in case["sh_stdout"]


@pytest.mark.parametrize("scores,want", [((0.5, 0.25), "bce"), ((0.25, 0.5), "lovasz_hinge"),
                                         ((0.375, 0.375), "lovasz_hinge")])
def test_winner_follows_run_sh_ties_to_loss_b(runs, scores, want):
    assert pipeline.winner("bce", "lovasz_hinge", *scores) == want
    # and run.sh picks the same on the same scores (the stage-3 fits' loss)
    name = {"bce": "binary-4-bce-wins", "lovasz_hinge": "binary-4-lovasz-wins"}[want]
    if scores[0] == scores[1]:
        name = "binary-3-tie"
    stage3 = runs[name]["sh_argvs"][2:6]
    assert {a[a.index("--loss") + 1] for a in stage3} == {want}


def test_plan_needs_the_winner_for_stage_three():
    assert pipeline.plan("binary", 2) == [("unet_resnet50", "bce"),
                                          ("unet_resnet50", "lovasz_hinge")]
    with pytest.raises(ValueError, match="stage-2 winner"):
        pipeline.plan("binary", 3)
    assert len(pipeline.plan("multiclass", 4, "unet_plain", "focal")) == 10


def test_pipeline_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(BASE + SYNTH)


# --- real fits on the CPU ------------------------------------------------------------------

REAL = BASE + SYNTH + ["--model", "unet_plain", "--device", "cpu"]


def _configs(cwd) -> list[dict]:
    out = []
    for exp in sorted(glob.glob(str(cwd / "run" / "train" / "exp*")),
                      key=lambda p: int(os.path.basename(p)[3:] or 0)):
        with open(os.path.join(exp, "config.json")) as f:
            out.append(json.load(f))
    return out


def test_binary_pipeline_to_stage_one_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    records = pipeline.main(REAL + ["--task", "binary", "--max-stage", "1"])
    assert [(r["model"], r["loss"]) for r in records] == pipeline.plan("binary", 1, "unet_plain")
    cfgs = _configs(tmp_path)
    assert [(c["model"], c["loss"], c["amp"]) for c in cfgs] == [
        ("unet_plain", "bce", False), ("unet_plain", "lovasz_hinge", False)]
    # make_tables runs as run.sh runs it (no --loss-compare-model): table 3-1
    # is unet_resnet50's, so the unet_plain fits are in the ablation and all-runs tables
    for table, key in (("all_runs.csv", "loss"), ("table_4_2_ablation.csv", "Loss")):
        with open(tmp_path / "run" / "tables" / table) as f:
            assert sorted(row[key] for row in csv.DictReader(f)) == ["bce", "lovasz_hinge"]


def _fit_files(exp: str) -> tuple[float, dict]:
    with open(os.path.join(exp, "summary.json")) as f:
        best = json.load(f)["best_score"]
    with open(os.path.join(exp, "test_metrics.json")) as f:
        return best, json.load(f)


def test_in_process_fits_equal_subprocess_fits(tmp_path, monkeypatch):
    args = pipeline.parse_args(REAL + ["--task", "binary", "--epochs", "2"])
    args.data_path = pipeline.resolve_data_path(args)
    argvs = [pipeline.fit_argv(args, "unet_plain", loss) for loss in ("lovasz_hinge", "bce")]
    (tmp_path / "proc").mkdir()
    (tmp_path / "sub").mkdir()
    monkeypatch.chdir(tmp_path / "proc")
    in_process = [_fit_files(pipeline.run_fit(argv)) for argv in argvs]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    for argv in argvs:
        subprocess.run([sys.executable, "-m", "unet_embroidery_seg_torch.train", *argv],
                       cwd=tmp_path / "sub", env=env, check=True, capture_output=True,
                       timeout=300)
    subs = [_fit_files(str(tmp_path / "sub" / "run" / "train" / e)) for e in ("exp", "exp1")]
    assert in_process == subs


@pytest.mark.slow
@pytest.mark.parametrize("task", ["binary", "multiclass", "multitask"])
def test_every_stage_of_each_task_on_the_cpu(tmp_path, monkeypatch, task):
    monkeypatch.chdir(tmp_path)
    records = pipeline.main(REAL + ["--task", task])
    a, b = pipeline.losses_for(task)
    scores = {r["loss"]: r["best_score"] for r in records[:2]}
    best = pipeline.winner(a, b, scores.get(a), scores.get(b)) if task != "multitask" else None
    fits = pipeline.plan(task, 4, "unet_plain", best)
    assert [(c["model"], c["loss"]) for c in _configs(tmp_path)] == fits
    if task != "multitask":
        with open(tmp_path / "run" / "tables" / "all_runs.csv") as f:
            assert len(list(csv.DictReader(f))) == len(fits)
