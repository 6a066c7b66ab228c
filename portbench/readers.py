"""What the per-layer metrics share: the profiled stretch, its units of work, kernel sums.

A reader returns None where it finds nothing to read (no trace, or a count
of launches that does not match the configuration's sites, so that the
time cannot be put on them): the harness then leaves its metric out.
"""

from __future__ import annotations

from portbench import counts
from portbench.harness import stretch
from portbench.kernel_groups import (CONV3X3_MAIN, CONV3X3_PACK, UPSAMPLE_BWD, UPSAMPLE_FWD,
                                     is_port, matches)


def units(run) -> int | None:
    """Steps (train) or calls (predict) in the profiled stretch."""
    s = run.stats
    return s.get("profiled_steps") or s.get("profiled_calls")


def stretch_ops(run) -> list | None:
    """The card's operations inside the profiled stretch; None where it has none."""
    span = stretch(run)
    if span is None:
        return None
    ops = [op for op in run.trace_data.device if op.ts >= span[0] and op.end <= span[1]]
    return ops or None


def ms_per_unit(run, ops) -> float:
    return sum(op.dur for op in ops) / 1e3 / units(run)


def step_ops(run, inside: bool) -> list | None:
    """The stretch's card ops launched inside (or outside) the step spans."""
    ops = stretch_ops(run)
    if ops is None or not units(run):
        return None
    chosen = set(map(id, run.trace_data.launched_inside("portbench.train_step")[0 if inside else 1]))
    return [op for op in ops if id(op) in chosen]


def dispatch_ms(run) -> float | None:
    d = run.stats.get("dispatch_s")
    return 1e3 * sum(d) / len(d) if d else None


def mfu(run, passes: int) -> float:
    """Share (%) of the card's dense peak in the window: model operations per image x images/s."""
    return 100.0 * passes * run.flops_per_image * run.stats["img_per_s"] / run.peak_flops()


def idle(run) -> float | None:
    span = stretch(run)
    if span is None or span[1] <= span[0] or stretch_ops(run) is None:
        return None
    return 100.0 * (1.0 - run.trace_data.busy(*span) / (span[1] - span[0]))


def library_ms(run) -> float | None:
    ops = step_ops(run, inside=True)
    return None if ops is None else ms_per_unit(run, [op for op in ops if not is_port(op.name)])


def input_ms(run) -> float | None:
    ops = step_ops(run, inside=False)
    return None if ops is None else ms_per_unit(run, ops)


def conv3x3_roofline(run, dgrad: bool) -> float | None:
    """Least time of the square-conv sites' work over the card time spent on it (%)."""
    ops, n = stretch_ops(run), units(run)
    sites = run.config["square_conv_sites"]
    if ops is None or not n or not sites:
        return None
    main = [op for op in ops if matches(op.name, CONV3X3_MAIN)]
    if len(main) != n * len(sites) * (2 if dgrad else 1):
        return None
    spent = main + [op for op in ops if matches(op.name, CONV3X3_PACK)]
    c = run.cell
    _, least = counts.conv3x3_work(sites, c["size"], c["batch"], c["dtype"], dgrad)
    return 100.0 * least * 1e3 / ms_per_unit(run, spent)


def upsample_roofline(run, backward: bool) -> float | None:
    ops, n = stretch_ops(run), units(run)
    sites = run.config["upsample_sites"]
    if ops is None or not n or not sites:
        return None
    fwd = [op for op in ops if matches(op.name, UPSAMPLE_FWD)]
    bwd = [op for op in ops if matches(op.name, UPSAMPLE_BWD)]
    if len(fwd) != n * len(sites) or len(bwd) != (n * len(sites) if backward else 0):
        return None
    c = run.cell
    least = counts.upsample_work(sites, c["size"], c["batch"], c["dtype"], backward)
    return 100.0 * least * 1e3 / ms_per_unit(run, fwd + bwd)
