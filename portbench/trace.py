"""A bounded stretch of a run under ``torch.profiler``, read back from its chrome trace.

``Tracer`` profiles the card only (CUDA activity: kernels, copies, memsets
and the runtime calls that launch them). Recording every host operator as
well slowed the host-bound train step 2x (91 against 45 ms a step on an
H100); the card alone costs it ~17% (52 ms). The benchmark's own spans
(``Tracer.span``) are timed on the host's wall clock and placed on the
trace's clock by its ``baseTimeNanoseconds`` (the trace's microseconds
count from it). After the stretch the trace is written to a temporary
file, read and deleted. ``Trace`` holds what the per-layer readers use:

- ``device``: every kernel, copy and memset on the card, with its name,
  start, duration and the time of the runtime call that launched it
  (matched by correlation id);
- ``spans``: the benchmark's spans, by name;
- ``host``: the runtime calls, for naming idle gaps.

Times are microseconds on the trace's clock. A kernel is inside a span when
its launch call is: the backward's kernels are launched by autograd's
device thread while the step's thread waits inside its span.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Op:
    name: str
    ts: float
    dur: float
    launch: float | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    device: list[Op] = field(default_factory=list)
    spans: dict[str, list[Op]] = field(default_factory=dict)
    host: list[Op] = field(default_factory=list)

    @classmethod
    def from_chrome(cls, doc: dict, spans_ns: list[tuple[str, int, int]] = ()) -> "Trace":
        """The trace of a chrome-trace document, with ``spans_ns`` ((name, start, end) in
        wall-clock nanoseconds) placed on its clock; spans need ``baseTimeNanoseconds``."""
        launches, device, host = {}, [], []
        for e in doc["traceEvents"]:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            op = Op(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                op.launch = args.get("correlation")
                device.append(op)
            elif cat in RUNTIME_CATS:
                if "correlation" in args:
                    launches[args["correlation"]] = op.ts
                host.append(op)
        for op in device:
            op.launch = launches.get(op.launch)
        device.sort(key=lambda o: o.ts)
        spans: dict[str, list[Op]] = {}
        base = doc.get("baseTimeNanoseconds")
        if base is not None:
            for name, t0, t1 in spans_ns:
                spans.setdefault(name, []).append(Op(name, (t0 - base) / 1e3, (t1 - t0) / 1e3))
        for ops in spans.values():
            ops.sort(key=lambda o: o.ts)
        return cls(device, spans, host)

    def stretch(self, span: str) -> tuple[float, float] | None:
        """(start, end) from the first ``span`` range's start to the last one's end."""
        ops = self.spans.get(span)
        return None if not ops else (ops[0].ts, max(o.end for o in ops))

    def busy(self, t0: float, t1: float) -> float:
        """Microseconds of [t0, t1) in which some operation ran on the card."""
        return sum(b - a for a, b in self.busy_intervals(t0, t1))

    def busy_intervals(self, t0: float, t1: float) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for op in self.device:
            a, b = max(op.ts, t0), min(op.end, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def launched_inside(self, span: str) -> tuple[list[Op], list[Op]]:
        """(card ops whose launch lies inside a ``span`` range, the others)."""
        ranges = self.spans.get(span, [])
        starts = [r.ts for r in ranges]
        inside, outside = [], []
        for op in self.device:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            (inside if i >= 0 and op.launch <= ranges[i].end else outside).append(op)
        return inside, outside

    def idle_gaps(self, t0: float, t1: float) -> list[tuple[str, float]]:
        """The card's idle gaps in [t0, t1), named by the innermost span covering each gap's
        midpoint and the runtime call the host was in there (if any), summed in seconds by name,
        longest first."""
        busy = self.busy_intervals(t0, t1)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        host = sorted(self.host, key=lambda o: o.ts)
        starts = [o.ts for o in host]
        ranges = sorted((o for ops in self.spans.values() for o in ops), key=lambda o: o.ts)
        by_name: dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [r for r in ranges if r.ts <= mid <= r.end]
            where = min(inner, key=lambda r: r.dur).name if inner else "(outside spans)"
            i = bisect.bisect_right(starts, mid) - 1
            call = host[i].name if i >= 0 and host[i].end >= mid else "host code"
            name = f"{where} / {call}"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])


class Tracer:
    """Profile one bounded stretch of a run; ``trace`` is set once it has stopped."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.trace: Trace | None = None
        self._prof = None
        self._spans: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        """Time ``portbench.<name>`` on the wall clock while profiling; else do nothing."""
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((f"portbench.{name}", t0, time.time_ns()))

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        acts = ([torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [torch.profiler.ProfilerActivity.CPU])
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._prof.stop()
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace.from_chrome(json.load(f), self._spans)
        finally:
            os.unlink(path)
        self._prof = None
