"""Time the predict call's host<->card copies on the card: pageable against ``engine/host_copy``'s
page-locked staging at several chunk sizes, slot counts and host thread counts.

    python scripts/torch_host_copy_probe.py [--batch 32] [--size 480] [--rounds 30]
        [--chunks-mb 4,8,16,32,0] [--slots 2,3] [--threads 8,4]
        [--out run/host_copy_probe.json]

The shapes are the predict cells': NHWC float32 images (3 channels) up from
a pageable numpy array, the two-class probabilities (N, H, W, 2) down into
a fresh numpy array, as ``predict_probs`` moves them, and down again into
an array made ahead (``host_copy._fresh``, outside the timing). A chunk of
0 MB is the whole batch in one chunk. Each round runs every variant once in
turn (the order reversed every other round); an upload is timed by the
host's clock to its synchronise, a download to its return. Every variant's
bytes are held to the pageable copy's. Then the host's parts alone at each
thread count: the pageable images into a page-locked buffer, a page-locked
buffer into a fresh and into a reused numpy array, a fresh array's first
touch, and making one ahead (``host_copy._fresh``). Prints one line per row (median and quartiles in ms, GB/s at
the median) and the card and host's threads, and writes all of it as
JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from unet_embroidery_seg_torch.engine import host_copy  # noqa: E402


def _ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def _machine() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=False).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": q,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "torch_threads": torch.get_num_threads(), "cpus": len(os.sched_getaffinity(0))}


def _stats(ts: list[float], nbytes: int) -> dict:
    q1, med, q3 = statistics.quantiles([t * 1e3 for t in ts], n=4)
    return {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "gb_per_s": nbytes / med / 1e6}


def _line(name: str, row: dict) -> str:
    return (f"{row['median_ms']:8.3f} ms [{row['q1_ms']:.3f}, {row['q3_ms']:.3f}] "
            f"{row['gb_per_s']:6.2f} GB/s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=480)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--chunks-mb", type=_ints, default=[4, 8, 16, 32, 0])
    p.add_argument("--slots", type=_ints, default=[2, 3])
    p.add_argument("--threads", type=_ints, default=[torch.get_num_threads()])
    p.add_argument("--out", default="run/host_copy_probe.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    threads0 = torch.get_num_threads()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    images = rng.random((args.batch, args.size, args.size, 3), dtype=np.float32)
    probs = torch.rand((args.batch, args.size, args.size, 2), device=dev)
    want_up = torch.as_tensor(images).to(dev)
    want_down = probs.cpu().numpy()
    up_bytes, down_bytes = images.nbytes, want_down.nbytes

    def pageable():
        def ahead(out):
            torch.from_numpy(out).copy_(probs)
            return out
        return ((lambda: torch.as_tensor(images).to(dev)), (lambda: probs.cpu().numpy()), ahead)

    def staged(ring):
        def up():
            out = torch.empty(images.shape, dtype=torch.float32, device=dev)
            host_copy.stage_upload(ring, torch.as_tensor(images), out)
            return out

        def ahead(out):
            host_copy.stage_download(ring, probs, torch.from_numpy(out))
            return out
        return up, (lambda: ahead(np.empty(want_down.shape, np.float32))), ahead

    variants = {"pageable": (threads0, *pageable())}
    for t in args.threads:
        for mb in args.chunks_mb:
            for slots in args.slots:
                ring = host_copy.Ring((mb << 20) or max(up_bytes, down_bytes), slots)
                variants[f"staged_{mb or 'whole'}MB_x{slots}_t{t}"] = (t, *staged(ring))
    fresh = lambda: host_copy._fresh(want_down.shape)  # noqa: E731
    for name, (t, up, down, ahead) in variants.items():  # warm-up and the bytes
        torch.set_num_threads(t)
        for _ in range(2):
            got_up, got_down, got_ahead = up(), down(), ahead(fresh())
        torch.cuda.synchronize()
        assert torch.equal(got_up, want_up), name
        assert np.array_equal(got_down, want_down), name
        assert np.array_equal(got_ahead, want_down), name
    directions = ("up", "down", "ahead")
    times = {(n, d): [] for n in variants for d in directions}
    names = list(variants)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            t, up, down, ahead = variants[name]
            torch.set_num_threads(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up()
            torch.cuda.synchronize()
            times[(name, "up")].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            down()
            times[(name, "down")].append(time.perf_counter() - t0)
            out = fresh()
            t0 = time.perf_counter()
            ahead(out)
            times[(name, "ahead")].append(time.perf_counter() - t0)

    pinned_up = torch.empty(images.shape, dtype=torch.float32, pin_memory=True)
    pinned_down = torch.empty(want_down.shape, dtype=torch.float32, pin_memory=True)
    reused = np.empty(want_down.shape, np.float32)
    src = torch.as_tensor(images)
    host_ops = {
        "pageable_to_pinned": (lambda: pinned_up.copy_(src), up_bytes),
        "pinned_to_fresh": (lambda: torch.from_numpy(np.empty(want_down.shape, np.float32))
                            .copy_(pinned_down), down_bytes),
        "pinned_to_reused": (lambda: torch.from_numpy(reused).copy_(pinned_down), down_bytes),
        "fresh_first_touch": (lambda: torch.from_numpy(np.empty(want_down.shape, np.float32))
                              .fill_(0.0), down_bytes),
        "made_ahead": (fresh, down_bytes),
    }
    host_threads = sorted({1, 2, 4, threads0, *args.threads})
    host_times = {(n, t): [] for n in host_ops for t in host_threads}
    for r in range(args.rounds):
        for t in host_threads:
            torch.set_num_threads(t)
            for name, (fn, _) in host_ops.items():
                t0 = time.perf_counter()
                fn()
                host_times[(name, t)].append(time.perf_counter() - t0)
    torch.set_num_threads(threads0)

    report = {"machine": _machine(), "batch": args.batch, "size": args.size,
              "rounds": args.rounds, "up_bytes": up_bytes, "down_bytes": down_bytes,
              "variants": {}, "host": {}}
    for name in variants:
        row = report["variants"][name] = {
            d: _stats(times[(name, d)], up_bytes if d == "up" else down_bytes)
            for d in directions}
        print(f"{name:22s} " + "  ".join(f"{d} {_line(name, row[d])}" for d in directions))
    for (name, t), ts in host_times.items():
        row = report["host"][f"{name}_t{t}"] = _stats(ts, host_ops[name][1])
        print(f"host {name:20s} t{t}  {_line(name, row)}")
    print(json.dumps(report["machine"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
