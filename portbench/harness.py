"""One run of one cell: set-up, the measured window, the comparison, the result line.

A cell is found by name. ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and the limits of its comparison; the mix names its entry
(``entries/<entry>.py``), which drives the program; each per-layer metric
is read by ``metrics/<metric>.py``. A later cell, mix, configuration or
metric is a new file and a new entry in ``BENCHMARK.json``, no edit.

The run: the entry's ``Session`` sets up (the program's model and inputs
made from the seed, every shape of the cell warmed up), then its
``window`` measures for ``--seconds`` (and, with ``--trace 1``, profiles a
bounded stretch after it). The peak of device memory is read, the
program's state freed, and the process must hold no JAX module. Then the
reference runs from the seed alone and the entry's gaps are held to the
cell's limits (``check.py``). With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from functools import cached_property
from pathlib import Path

import torch

from portbench import check, counts
from portbench.reference import models as ref_models
from portbench.trace import Tracer

PKG = Path(__file__).resolve().parent
MANIFEST = PKG.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_embroidery_seg_tpu")
CONTROL = {"bf16": "fp8", "f32": "bf16"}  # the precision one step below each stated one
WITNESS = {"bf16": "bf16", "f32": "tf32"}  # each stated precision, in the reference
NAME_CHARS = 160  # of a kernel's name in the breakdown


class ForbiddenModules(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def load_cell(name: str, root: Path = PKG) -> tuple[dict, dict]:
    """(cell: the workload file merged over its traffic mix, with ``name``; configuration)."""
    cell = load_json(root / "workloads" / f"{name}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    return {**traffic, **cell, "name": name}, config


def load_plugin(kind: str, name: str, root: Path = PKG):
    """The module ``<root>/<kind>/<name>.py`` (names may hold dots)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What the entries and the per-layer readers share for one run."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: dict | None = None, fault: str | None = None,
                 t_start: float | None = None, manifest: dict | None = None):
        self.manifest = load_manifest() if manifest is None else manifest
        self.cell, self.config = load_cell(workload)
        self.cell.update(overrides or {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.fault = fault
        self.t_start = time.time() if t_start is None else t_start
        self.t_first_step = None
        self.tracer = Tracer(trace)
        self.stats: dict = {}
        self.stretch_span = None  # the entry's span of one traced unit of work

    def mark_first_step(self) -> None:
        self.t_first_step = time.time()

    @property
    def trace_data(self):
        return self.tracer.trace

    @cached_property
    def flops_per_image(self) -> float:
        """Forward operations of one image at the cell's size (the reference's layer shapes)."""
        with torch.device("meta"):
            model = ref_models.build(self.config, diff=False)
        return counts.model_flops(model, self.cell["size"])

    def peak_flops(self) -> float:
        return counts.peak_flops(self.cell["dtype"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, fault: str | None = None,
             t_start: float | None = None, manifest: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    run = Run(workload, seed, seconds, trace, device, overrides, fault, t_start, manifest)
    entry = load_plugin("entries", run.cell["entry"])
    if fault is not None and fault not in entry.Session.FAULTS:
        raise ValueError(f"fault {fault!r} not in {entry.Session.FAULTS}")
    run.stretch_span = entry.Session.STRETCH
    session = entry.Session(run)
    out = session.window()
    run.stats = out["stats"]
    dev = run.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    session.free()
    gc.collect()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules of the JAX package or JAX are loaded: {found}")

    gaps = readings(session, session.program_readings(), run.cell)
    ok, rows = check.verdict(gaps, run.cell["limits"])
    rows.append({"name": "failed", "value": out["failed"], "limit": 0})
    correct = ok and out["failed"] == 0

    cell = run.cell["name"]
    metrics = {}
    if not trace:
        setup_s = run.t_first_step - run.t_start
        values = {"setup_s": setup_s, **out["metrics"]}
        for m in run.manifest["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in run.manifest["per_layer"]:
            if applies(m, cell):
                value = load_plugin("metrics", m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info(run, peak)}
    if trace and run.trace_data is not None:
        result["breakdown"] = breakdown(run)
    result["checks"] = rows
    return result


def readings(session, got, cell: dict, want=None, witness=None) -> dict:
    """The numbers of ``got`` (the program's readings, or what stands in its place) against the
    reference in float32, with their ratios to the witness's where the cell's limits hold one."""
    want = session.reference("f32") if want is None else want
    gaps = session.gaps(got, want)
    if any(k.endswith("_ratio") for k in cell["limits"]):
        if witness is None:
            witness = session.gaps(session.as_program(session.reference(WITNESS[cell["dtype"]])),
                                   want)
        gaps = check.with_ratios(gaps, witness)
    return gaps


def stretch(run) -> tuple[float, float] | None:
    """The profiled stretch: from the first traced span's start to the last one's end."""
    t = run.trace_data
    return None if t is None else t.stretch(f"portbench.{run.stretch_span}")


def device_info(run, peak: int) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1, "memory_peak_bytes": int(peak)}
    span = stretch(run)
    if span is not None:
        info["busy_s"] = run.trace_data.busy(*span) / 1e6
        info["window_s"] = (span[1] - span[0]) / 1e6
    return info


def breakdown(run) -> dict:
    """The profiled stretch's ten longest device operations by name, and its ten longest idle
    gaps by what the host was doing, in seconds."""
    span = stretch(run)
    if span is None:
        return {"device_ops": [], "idle_gaps": []}
    by_name: dict[str, float] = {}
    for op in run.trace_data.device:
        if op.ts >= span[0] and op.end <= span[1]:
            by_name[op.name[:NAME_CHARS]] = by_name.get(op.name[:NAME_CHARS], 0.0) + op.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = run.trace_data.idle_gaps(*span)[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}
