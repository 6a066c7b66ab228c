"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads nothing of the
program. Checked in fresh processes, by the top-level name of every module loaded."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = harness.PKG.parent


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_entries_and_metrics_load_no_jax():
    manifest = harness.load_manifest()
    entries = sorted({harness.load_cell(w["name"])[0]["entry"] for w in manifest["workloads"]})
    code = "\n".join([
        "import portbench.run, portbench.control, portbench.readers",
        "from portbench import harness",
        *[f"harness.load_plugin('entries', {e!r})" for e in entries],
        *[f"harness.load_plugin('metrics', {m['name']!r})" for m in manifest["per_layer"]],
        # what the entries import of the program when a session starts
        "import unet_embroidery_seg_torch.engine.resident, unet_embroidery_seg_torch.engine.steps",
        "import unet_embroidery_seg_torch.models, unet_embroidery_seg_torch.ops.schedules",
        "import unet_embroidery_seg_torch.predict, unet_embroidery_seg_torch.utils.device",
    ])
    loaded = _loaded(code)
    assert "unet_embroidery_seg_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    modules = sorted(p.stem for p in (harness.PKG / "reference").glob("*.py") if p.stem != "__init__")
    loaded = _loaded("\n".join(f"import portbench.reference.{m}" for m in modules))
    assert "unet_embroidery_seg_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)
    for path in (harness.PKG / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("unet_embroidery_seg_torch", *harness.FORBIDDEN)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    monkeypatch.setitem(sys.modules, "unet_embroidery_seg_tpu_x", sys)
    assert harness.forbidden_modules() == [m for m in harness.FORBIDDEN if m in
                                           {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "unet_embroidery_seg_tpu.models", sys)
    assert "unet_embroidery_seg_tpu" in harness.forbidden_modules()
