"""Card time of a call, by CUDA events: eagerly, and by CUDA-graph replay.

``event_ms`` times calls back to back from the host, so a call whose card
time is shorter than its Python dispatch (~20 us for a kernel wrapper) is
timed as the host issues it. ``graph_ms`` captures the calls into a CUDA
graph and replays it, which takes the host out of the loop: the card's own
time. Both need a CUDA card.
"""

from __future__ import annotations

import torch

__all__ = ["event_ms", "graph_ms"]


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
