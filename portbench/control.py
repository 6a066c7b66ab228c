"""The readings a cell's limits are set from: sound runs, the control, the planted faults.

    python -m portbench.control --workload <cell> --first-seed <n> --seeds 12 \
        --control-seeds 3 --fault-seeds 3 --out control_<cell>.jsonl

In one process, at the cell's own sizes: for each seed, the program's
set-up (and, for a predict cell, a short window) and its gaps against the
reference in float32, and the witness's (the reference at the cell's own
precision, ``harness.WITNESS``: what rounding alone gives), every number
with its ratio to the witness's; on the first ``--control-seeds`` seeds the
control too, the reference computed one precision step below the cell's
(``harness.CONTROL``) and put in the program's place; on the first
``--fault-seeds`` seeds each planted fault of the entry (``Session.FAULTS``)
that needs a run. Every reading is written as one JSON line; the summary
printed last gives, for each number, the largest sound reading (the lower
one) and the smallest of the control and of each fault. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check, harness

NEEDS_NO_RUN = ("unchanged_state",)  # reads 1 on the grad and change gaps by their definition
WINDOW_S = 3.0  # a predict cell's short window at its own load
WINDOW_CHECK_SHARE = 0.2


def session(cell: str, seed: int, device: str, overrides: dict, fault=None):
    run = harness.Run(cell, seed, WINDOW_S, False, device, overrides, fault)
    entry = harness.load_plugin("entries", run.cell["entry"])
    run.stretch_span = entry.Session.STRETCH
    s = entry.Session(run)
    if run.cell["entry"] == "predict":
        s.window()
    return run, s


def release(s) -> None:
    s.free()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell: str, seeds: list[int], control_seeds: int, fault_seeds: int,
             device: str = "cuda", overrides: dict | None = None, out=None) -> list[dict]:
    rows = []

    def add(row: dict) -> None:
        rows.append(row)
        if out is not None:
            out.write(json.dumps(row) + "\n")
            out.flush()

    for i, seed in enumerate(seeds):
        run, s = session(cell, seed, device, overrides or {})
        got = s.program_readings()
        release(s)
        want = s.reference("f32")
        precision = harness.WITNESS[run.cell["dtype"]]
        witness = s.gaps(s.as_program(s.reference(precision)), want)
        every = {"limits": {"_ratio": 0}, "dtype": run.cell["dtype"]}  # every number, its ratio
        numbers = lambda x: harness.readings(s, x, every, want, witness)  # noqa: E731
        add({"seed": seed, "kind": "sound", **numbers(got)})
        add({"seed": seed, "kind": f"witness_{precision}", **check.with_ratios(witness, witness)})
        if i < control_seeds:
            low = harness.CONTROL[run.cell["dtype"]]
            add({"seed": seed, "kind": f"control_{low}", **numbers(s.as_program(s.reference(low)))})
        if i < fault_seeds:
            for fault in s.FAULTS:
                if fault in NEEDS_NO_RUN:
                    continue
                _, f = session(cell, seed, device, overrides or {}, fault)
                bad = f.program_readings()
                release(f)
                # a predict fault keeps other calls than the sound run: its own reference
                add({"seed": seed, "kind": f"fault_{fault}",
                     **harness.readings(f, bad, every)})
        print(f"seed {seed} done at {time.strftime('%H:%M:%S')}", file=sys.stderr, flush=True)
    return rows


def summary(rows: list[dict]) -> dict:
    numbers = [k for k in rows[0] if k not in ("seed", "kind") and not k.startswith("_")]
    out = {}
    for k in numbers:
        by_kind: dict[str, list[float]] = {}
        for r in rows:
            by_kind.setdefault(r["kind"], []).append(r[k])
        out[k] = {"lower": max(by_kind["sound"]),
                  **{kind: min(v) for kind, v in by_kind.items() if kind != "sound"},
                  "sound_n": len(by_kind["sound"])}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    overrides = {"check_share": WINDOW_CHECK_SHARE}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as out:
        rows = readings(args.workload, seeds, args.control_seeds, args.fault_seeds,
                        overrides=overrides, out=out)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
