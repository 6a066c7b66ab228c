#!/usr/bin/env python3
"""chip_smoke.py's phase 12a (the synchronised BN against cuDNN's) alone, in a fresh process.

    python scripts/torch_sync_bn_probe.py check [--root DIR] [--repeat 3] [--sync-budget-ms MS]
    python scripts/torch_sync_bn_probe.py reference [--root DIR] [--order cudnn_first|sync_first]

``check``: ``chip_smoke.sync_bn_check`` of the checkout at ``--root``
(default: this one) ``--repeat`` times on a 1-rank NCCL group, printing each
call's relative errors or its failure. Its timer (``utils/timing.event_ms``
of that checkout) is wrapped to count the forward + backward calls it makes
on each side, so each line also gives, per dtype, how many backward passes
each side's ``x.grad`` holds (the one recorded before timing plus the
timer's) and the range of ``x.grad`` sync / cuDNN over the elements whose
cuDNN value is at least 1% of its largest, beside the ratio of the two
counts. ``--sync-budget-ms`` gives the sync side's timer that budget in
place of 300 ms, so that the two sides make different numbers of calls.
``reference``: the f32 dx of cuDNN's BN and of the synchronised BN at the
check's shape and inputs, each against an f64 reference of train-mode BN's
dx, three times in the order given. Prints one line per call. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _reference(chip_smoke, group, order: list[str]) -> None:
    import torch

    from unet_embroidery_seg_torch.models.blocks import BatchNorm, set_batchnorm_group

    shape = chip_smoke.BN_SHAPE
    c = shape[1]
    gen = torch.Generator("cuda").manual_seed(12)
    cl = torch.channels_last
    x0 = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).contiguous(memory_format=cl)
    gy = torch.randn(shape, generator=gen, device="cuda").contiguous(memory_format=cl)
    state = chip_smoke._bn_state(c, 12)
    xd, gd, dims = x0.double(), gy.double(), (0, 2, 3)
    mean, var = xd.mean(dims, keepdim=True), xd.var(dims, unbiased=False, keepdim=True)
    invstd = (var + 1e-5).rsqrt()
    xhat = (xd - mean) * invstd
    w = state["weight"].double().cuda()[None, :, None, None]
    ref = w * invstd * (gd - gd.mean(dims, keepdim=True)
                        - xhat * (gd * xhat).mean(dims, keepdim=True))

    def dx_err(name: str) -> float:
        bn = BatchNorm(c).cuda()
        bn.load_state_dict(state)
        set_batchnorm_group(bn.train(), group if name == "sync" else None)
        x = x0.clone().requires_grad_(True)
        (bn(x).float() * gy).sum().backward()
        torch.cuda.synchronize()
        return ((x.grad.double() - ref).abs().max() / ref.abs().max()).item()

    for i in range(3):
        print("reference", i, json.dumps({name: dx_err(name) for name in order}), flush=True)


def _counting_timer(log: list, sync_budget_ms: float | None):
    """Wrap the checkout's ``event_ms``: each call logs its side, its calls and its ``x``.

    ``sync_bn_check`` times cuDNN's side, then the sync side, once per
    dtype; its timed closure takes ``x`` as its second default argument.
    """
    from unet_embroidery_seg_torch.utils import timing

    real = timing.event_ms

    def timer(fn, budget_ms: float = 300.0) -> float:
        side = ("cudnn", "sync")[len(log) % 2]
        calls = [0]

        def counted():
            calls[0] += 1
            return fn()

        if side == "sync" and sync_budget_ms is not None:
            budget_ms = sync_budget_ms
        ms = real(counted, budget_ms)
        log.append({"side": side, "timer_calls": calls[0], "x": fn.__defaults__[1]})
        return ms

    timing.event_ms = timer


def _grad_counts(log: list) -> dict:
    """Per dtype: the backward passes each side's x.grad holds, and its sync / cuDNN range."""
    out = {}
    for label, (cudnn, sync) in zip(("f32", "bf16"), zip(log[0::2], log[1::2])):
        a, b = cudnn["x"].grad.float(), sync["x"].grad.float()
        big = a.abs() >= 0.01 * a.abs().max()
        ratio = b[big] / a[big]
        passes = {"cudnn": 1 + cudnn["timer_calls"], "sync": 1 + sync["timer_calls"]}
        out[label] = {"backward_passes": passes,
                      "x_grad_ratio_range": [ratio.min().item(), ratio.max().item()],
                      "passes_ratio": passes["sync"] / passes["cudnn"]}
    log.clear()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("check", "reference"))
    parser.add_argument("--root", type=Path, default=ROOT, help="checkout whose chip_smoke.py runs")
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--order", choices=("cudnn_first", "sync_first"), default="cudnn_first")
    parser.add_argument("--sync-budget-ms", type=float, default=None,
                        help="check: the sync side's timer budget (default: the check's own)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_sync_bn_probe: no CUDA device available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch.distributed as dist

    import chip_smoke
    from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = tempfile.mkdtemp(prefix="nccl-1-rank-")
    mesh_lib.init_multihost(f"file://{os.path.join(store, 'store')}", 1, 0, backend="nccl")
    try:
        if args.what == "check":
            log: list = []
            _counting_timer(log, args.sync_budget_ms)
            for i in range(args.repeat):
                try:
                    result = chip_smoke.sync_bn_check(dist.group.WORLD)
                    print("check_ok", i, json.dumps(result["f32"]["rel_err"]), flush=True)
                except AssertionError as e:
                    print("check_failed", i, e, flush=True)
                print("grad_counts", i, json.dumps(_grad_counts(log)), flush=True)
        else:
            _reference(chip_smoke, dist.group.WORLD,
                       ["cudnn", "sync"] if args.order == "cudnn_first" else ["sync", "cudnn"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
