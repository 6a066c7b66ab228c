"""The benchmark's command: one run of one cell, its result as the last line of standard output.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on and needs as many CUDA cards as the
cell asks for: with fewer, or none, it exits with code 2 and prints no
result. It never falls back to the CPU. The kernels' build directory is
the program's own (``build/kernels`` in the checkout); the caches of
PyTorch's extension builds, Triton and CUDA's JIT are set to fixed
directories under ``build/`` in the checkout too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda_cache"}


def process_start() -> float:
    """Wall-clock time at which this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(REPO / "build" / sub)
    import torch

    from portbench import harness

    manifest = harness.load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START, manifest=manifest)
    except harness.ForbiddenModules as e:
        print(e, file=sys.stderr)
        return 3
    sys.stdout.flush()
    for row in result["checks"]:
        print(f"check {row['name']} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
