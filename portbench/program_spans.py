"""The program's own spans on the trace's clock, and what the per-layer metrics read of them.

The program (``unet_embroidery_seg_torch/utils/profiling.span``) records
spans while a profiler records, as (name, start, end, thread, parent) in
wall-clock nanoseconds (``time.time_ns``, the clock of the harness's own
spans): ``input.batch`` per resident step; ``step.train`` around each train
step and inside it ``step.forward``, ``step.loss``, ``step.backward`` and
``step.optimizer``; ``predict.call`` around ``predict_probs`` and inside it
``predict.h2d``, ``predict.forward``, ``predict.d2h``; ``op.conv3x3`` and
``op.conv3x3_dgrad`` around the square conv's operator calls (the dgrad's
on autograd's own thread).

``placed`` puts them on the trace's clock with the offset
``Trace.from_chrome`` gave the harness's spans, recovered from one of them
(its wall-clock start in ``run.tracer``, its trace-clock start in
``run.trace_data``), and keeps those inside the profiled stretch. A
program that records no spans (one older than them) gives None, and so
does every reader below: the harness then leaves the metric out.

Idle time is split by exact overlap: each stretch of card idle goes to
the innermost span of the step and input layers covering it (phases inside
``step.train`` / ``predict.call``). The operators' ``op.*`` spans lie inside
the phases and belong to the kernels layer: a phase's idle holds its
operators' idle. Idle outside every such span is counted in none.
"""

from __future__ import annotations

import bisect

from portbench import counts
from portbench.harness import stretch
from portbench.readers import stretch_ops, units
from portbench.trace import Op, Trace

TRAIN_PHASES = ("input.batch", "step.forward", "step.loss", "step.backward", "step.optimizer")
PREDICT_PHASES = ("predict.h2d", "predict.forward", "predict.d2h")
# the spans an idle stretch can fall to, each phase's root among them (its own idle between phases)
TRAIN_SPLIT = TRAIN_PHASES + ("step.train",)
PREDICT_SPLIT = PREDICT_PHASES + ("predict.call",)


def recorded() -> list[tuple] | None:
    """The program's spans as it recorded them, or None where it records none."""
    try:
        from unet_embroidery_seg_torch.utils import profiling

        return profiling.spans()
    except (ImportError, AttributeError):
        return None


def base_ns(run) -> int | None:
    """The trace's zero on the wall clock (ns), from the harness's first span: its start on
    the wall clock less its start on the trace's clock."""
    raw, trace = run.tracer._spans, run.trace_data
    if not raw or trace is None:
        return None
    name = raw[0][0]
    placed = trace.spans.get(name)
    if not placed:
        return None
    return min(t0 for n, t0, _ in raw if n == name) - round(placed[0].ts * 1e3)


def place(raw, base: int, t0: float, t1: float) -> dict[str, list[Op]]:
    """``raw`` spans on the trace's clock (us from ``base`` ns), those inside [t0, t1], by name."""
    out: dict[str, list[Op]] = {}
    for name, a, b, *_ in raw:
        op = Op(name, (a - base) / 1e3, (b - a) / 1e3)
        if op.ts >= t0 and op.end <= t1:
            out.setdefault(name, []).append(op)
    for ops in out.values():
        ops.sort(key=lambda o: o.ts)
    return out


def placed(run) -> dict[str, list[Op]] | None:
    """The program's spans inside the profiled stretch, on the trace's clock, by name."""
    raw, base, span = recorded(), base_ns(run), stretch(run)
    if raw is None or base is None or span is None:
        return None
    return place(raw, base, *span)


def counted(spans: dict[str, list[Op]] | None, names, n: int) -> bool:
    """Whether each of ``names`` has exactly ``n`` spans."""
    return spans is not None and n > 0 and all(len(spans.get(x, ())) == n for x in names)


def idle_intervals(trace, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1) with nothing on the card."""
    edges = [t0] + [x for ab in trace.busy_intervals(t0, t1) for x in ab] + [t1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def innermost(ranges: list[Op]) -> list[tuple[float, float, str]]:
    """[(a, b, name)]: the pieces of time some range covers, each named by the shortest range
    covering it (the innermost, where ranges nest)."""
    points = sorted({x for r in ranges for x in (r.ts, r.end)})
    out = []
    for a, b in zip(points, points[1:]):
        cover = [r for r in ranges if r.ts <= a and b <= r.end]
        if cover:
            out.append((a, b, min(cover, key=lambda r: r.dur).name))
    return out


def split_idle(idle: list[tuple[float, float]], ranges: list[Op]) -> dict[str, float]:
    """Microseconds of ``idle`` (sorted, disjoint) by the innermost of ``ranges`` covering them,
    by exact overlap; idle no range covers is counted in none."""
    pieces = innermost(ranges)
    starts = [a for a, _ in idle]
    out: dict[str, float] = {}
    for a, b, name in pieces:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(idle) and idle[i][0] < b:
            lo, hi = max(a, idle[i][0]), min(b, idle[i][1])
            if hi > lo:
                out[name] = out.get(name, 0.0) + (hi - lo)
            i += 1
    return out


def launched_in(ops: list[Op], ranges: list[Op]) -> list[Op]:
    """Of ``ops``, those whose launch call lies inside one of ``ranges`` (which do not overlap)."""
    return Trace(ops, {"in": sorted(ranges, key=lambda o: o.ts)}).launched_inside("in")[0]


def phase_idle_ms(run, phase: str) -> float | None:
    """Card-idle ms per step (train) or call (predict) inside ``phase``'s spans (innermost among
    the step and input spans: an operator's span counts to its phase)."""
    n, span, spans = units(run), stretch(run), placed(run)
    split = TRAIN_SPLIT if phase in TRAIN_SPLIT else PREDICT_SPLIT
    if span is None or not counted(spans, split, n) or stretch_ops(run) is None:
        return None
    ranges = [op for name in split for op in spans[name]]
    idle = split_idle(idle_intervals(run.trace_data, *span), ranges)
    return idle.get(phase, 0.0) / 1e3 / n


def step_launches(run) -> float | None:
    """Card operations launched inside ``step.train`` spans, per step."""
    n, spans, ops = units(run), placed(run), stretch_ops(run)
    if ops is None or not counted(spans, ("step.train",), n):
        return None
    return len(launched_in(ops, spans["step.train"])) / n


def conv3x3_op_roofline(run) -> float | None:
    """The square convs' least time (forward and input gradient) over the card time of every
    operation launched inside the ``op.conv3x3`` and ``op.conv3x3_dgrad`` spans (%)."""
    n, spans, ops = units(run), placed(run), stretch_ops(run)
    sites = run.config["square_conv_sites"]
    if ops is None or not sites or not counted(spans, ("op.conv3x3", "op.conv3x3_dgrad"),
                                               n * len(sites)):
        return None
    spent = launched_in(ops, spans["op.conv3x3"] + spans["op.conv3x3_dgrad"])
    if not spent:
        return None
    c = run.cell
    _, least = counts.conv3x3_work(sites, c["size"], c["batch"], c["dtype"], dgrad=True)
    return 100.0 * least * 1e6 * n / sum(op.dur for op in spent)


def copy_host_ms(run) -> float | None:
    """Host ms per predict call inside ``predict.h2d`` and ``predict.d2h``."""
    n, spans = units(run), placed(run)
    if not counted(spans, ("predict.h2d", "predict.d2h"), n):
        return None
    return sum(op.dur for x in ("predict.h2d", "predict.d2h") for op in spans[x]) / 1e3 / n
