"""BENCHMARK.json against the contract's rules, and the harness finding cells by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == TOP
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert all(not w.startswith("/") and ".." not in w for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in manifest["end_to_end"] else {"layer", "moves"}
        assert set(m) <= allowed
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def _reported(manifest, cell: str) -> set[str]:
    return {m["name"] for m in manifest["end_to_end"] if harness.applies(m, cell)}


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        e2e = _reported(manifest, cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, cell) for m in manifest["per_layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_each_layer_metric_moves_a_metric_its_cells_report(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        for cell in m.get("workloads", cells):
            assert m["moves"] in _reported(manifest, cell), (m["name"], cell)


def test_every_name_has_its_file(manifest):
    for c in manifest["configs"]:
        assert (harness.PKG.parent / c["file"]).is_file()
    for w in manifest["workloads"]:
        cell, config = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert config["name"] == w["config"] and config["reduced"] == []
        assert (harness.PKG / "entries" / f"{cell['entry']}.py").is_file()
        assert cell["limits"]
    for m in manifest["per_layer"]:
        assert callable(harness.load_plugin("metrics", m["name"]).read)


def test_a_dropped_cell_file_is_found_with_no_other_edit(tmp_path):
    for sub in ("workloads", "traffic", "configs", "metrics"):
        shutil.copytree(harness.PKG / sub, tmp_path / sub)
    (tmp_path / "traffic" / "predict_bf16_b8.json").write_text(json.dumps(
        {**json.loads((tmp_path / "traffic" / "predict_bf16_b32.json").read_text()), "batch": 8}))
    (tmp_path / "workloads" / "r50_predict_bf16_b8.json").write_text(json.dumps(
        {"config": "unet_resnet50", "traffic": "predict_bf16_b8", "limits": {"prob_gap": 1.0}}))
    (tmp_path / "metrics" / "calls.predict.py").write_text(
        "def read(run):\n    return run.stats.get('calls')\n")
    cell, config = harness.load_cell("r50_predict_bf16_b8", root=tmp_path)
    assert cell["batch"] == 8 and cell["entry"] == "predict" and config["model"] == "unet_resnet50"

    class Run:
        stats = {"calls": 7}

    assert harness.load_plugin("metrics", "calls.predict", root=tmp_path).read(Run) == 7
