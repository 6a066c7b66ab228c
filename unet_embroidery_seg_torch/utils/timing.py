"""Card time of a call, by CUDA events: eagerly, and by CUDA-graph replay.

``event_ms`` times calls back to back from the host, so a call whose card
time is shorter than its Python dispatch (~20 us for a kernel wrapper) is
timed as the host issues it. ``graph_ms`` captures the calls into a CUDA
graph and replays it, which takes the host out of the loop: the card's own
time. Both need a CUDA card. ``device_ms_by_group`` sums a
``torch.profiler`` window's card time by kernel group.
"""

from __future__ import annotations

import torch

__all__ = ["KERNEL_GROUPS", "device_ms_by_group", "event_ms", "graph_ms"]


def event_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean ms per call over a run of eager calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(max(3, min(50, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, probe_ms: float, budget_ms: float = 300.0) -> float:
    """Mean ms per call by replay of a CUDA graph holding calls of ``fn``.

    ``probe_ms`` (an eager time of one call) sizes the graph to ~2 ms of
    calls and the replays to ``budget_ms``.
    """
    reps = int(max(1, min(50, 2.0 / max(probe_ms, 1e-3))))
    rounds = int(max(2, min(20, budget_ms / max(probe_ms * reps, 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * rounds)


# Kernel-name fragments -> group, first match wins; the rest is "other elementwise".
KERNEL_GROUPS = [
    ("port upsample2x backward", ("upsample2x_bwd_kernel",)),
    ("port upsample2x", ("upsample2x_kernel",)),
    # The tensor-core kernel's f32 (tf32x3) instances, then every other conv3x3 launch.
    ("port conv3x3 f32 tf32x3 (forward and dgrad)", ("conv3x3_wgmma_kernel<float",)),
    ("port conv3x3 (forward and dgrad)", ("conv3x3_wgmma_kernel", "conv3x3_fma_kernel")),
    ("memcpy", ("Memcpy", "memcpy")),
    ("Adam (foreach)", ("multi_tensor", "foreach", "Adam", "adam")),
    ("sort (Lovasz)", ("sort", "Sort", "radix", "Radix")),
    ("cuDNN/cuBLAS conv and GEMM", ("conv", "gemm", "xmma", "sm90", "cutlass", "implicit",
                                    "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")),  # cuDNN f32: batchnorm_*
    ("cat", ("CatArrayBatchedCopy", "cat")),
    ("softmax", ("softmax",)),
    ("reductions and scans", ("reduce", "scan", "Scan")),
    ("pool", ("pool",)),
]


def _group_of(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def device_ms_by_group(prof, calls: int) -> tuple[dict[str, float], list[dict]]:
    """(card ms per call by kernel group, largest first; the 15 largest kernels) of a window.

    ``prof`` is a finished ``torch.profiler.profile`` over ``calls`` calls.
    The optimizer's and DDP's profiler annotations (ranges that span the
    kernels they launch) are skipped: the kernels count on their own.
    """
    by_group: dict[str, float] = {}
    top = []
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith(("Optimizer.", "DistributedDataParallel."))):
            continue
        ms = evt.self_device_time_total / 1e3 / calls
        if ms > 0:
            by_group[_group_of(evt.key)] = by_group.get(_group_of(evt.key), 0.0) + ms
            top.append((ms, evt.key[:90]))
    return (dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            [{"ms": ms, "name": n} for ms, n in sorted(top, reverse=True)[:15]])
