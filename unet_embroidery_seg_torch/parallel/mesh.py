"""Data parallelism over processes (port of ``parallel/mesh.py``): the mesh's ``data`` axis.

The JAX package runs one program over a ``(data, space)`` device mesh and
lets GSPMD insert the collectives. PyTorch has no such compiler, so the
port runs one process per card (``torch.distributed``), and the ``data``
axis is spelled out:

- each process holds a replica of the model and optimizer state
  (``replicate``) and takes its contiguous rows of every global batch
  (``shard_batch_arrays``: the rows JAX's data-axis shard holds);
- gradients are averaged over the group by ``DistributedDataParallel``
  (``engine/steps.py``);
- BatchNorm's statistics are summed over the group, as flax computes them
  on the global batch (``models/blocks.BatchNorm``);
- every loss and metric is the global batch's (``ops/losses.py``,
  ``ops/metrics.py``): local sums go through one all-reduce before any
  division.

The ``space`` axis (H split over devices, GSPMD's conv halo exchanges) is
not ported: stock PyTorch has no halo exchange, so every conv, pool,
resize and BatchNorm would need one written out (ROADMAP.md Queue 1 item
10b). ``n_space > 1`` raises.

Backends: NCCL on the card, gloo on the CPU (and gloo with CUDA tensors
where NCCL cannot go, two ranks on one card). A job is joined from
``torchrun``'s environment (``init_multihost()``), by an explicit address
on any number of hosts (``init_multihost(address, world, rank)``), or
started here with one worker process per rank (``launch_local``).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn as nn

Group = dist.ProcessGroup | None  # None: one process, no collective
SPACE_NOT_PORTED = "ROADMAP.md Queue 1 item 10b (the mesh's space axis)"
TIMEOUT_S = 600  # a rank that dies mid-collective stops the others after this


@dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis.

    ``group`` is None for a single process: the code paths of one device,
    with no wrapper and no collective.
    """

    rank: int
    world_size: int
    device: torch.device
    group: Group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a global batch of ``batch`` rows."""
        if batch % self.world_size:
            raise ValueError(f"batch of {batch} rows does not divide the data axis "
                             f"({self.world_size})")
        b = batch // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)


def backend_for(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def in_job() -> bool:
    """Whether this process is, or is about to join, a job of more than one process."""
    return dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def host_topology() -> tuple[int, int]:
    """(local rank, processes on this host) of this process in the joined job.

    Every rank all-gathers the name of its host (``socket.gethostname()``)
    over a gloo group made for the purpose, so
    that it works before a card is chosen under NCCL; the ranks that share
    a name share a host, and this process's local rank is its place among
    them. A collective: every rank of the job calls it.
    """
    import socket

    host = socket.gethostname()
    group = dist.new_group(backend="gloo")
    try:
        hosts: list = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, host, group=group)
    finally:
        dist.destroy_process_group(group)
    mine = [r for r, h in enumerate(hosts) if h == host]
    return mine.index(dist.get_rank()), len(mine)


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> int:
    """Join a ``torch.distributed`` job; returns this process's rank.

    With no arguments the job is ``torchrun``'s (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); without peers there (no
    ``WORLD_SIZE`` above 1) the call is a no-op that returns 0, as the JAX
    function is without a coordinator. Otherwise pass all three:
    ``coordinator_address`` is an ``init_method`` (``tcp://host:port``,
    ``file://path``) or a bare ``host:port``. A job joined so learns each
    process's local rank and its host's process count from the job itself
    (``host_topology``, by hostname) and sets ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` as ``torchrun`` does, so that ``make_mesh`` counts
    the devices of every host. ``backend`` defaults to NCCL when a card is present, else gloo;
    under NCCL this process's card is the one of its local rank, never its
    global rank. A process that already joined gets its rank back.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return 0
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("pass coordinator_address, num_processes and process_id together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    explicit = init_method != "env://"
    if backend == "nccl" and not explicit:
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if explicit:
        if world > 1:
            local_rank, local_world = host_topology()
            os.environ.update(LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(local_world))
        if backend == "nccl":  # before the first NCCL collective binds a card
            torch.cuda.set_device(_local_rank(rank))
    return rank


def check_mesh_size(n_data: int, n_space: int, n_devices: int) -> None:
    """Raise as the JAX package does for a mesh larger than the devices; refuse ``space``."""
    if n_space != 1:
        raise NotImplementedError(f"--mesh-space {n_space}: {SPACE_NOT_PORTED}")
    if n_data * n_space > n_devices:
        raise ValueError(f"mesh ({n_data}x{n_space}) needs {n_data * n_space} devices, "
                         f"have {n_devices}")


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices: list[torch.device] | None = None) -> Mesh:
    """This process's ``Mesh`` on a data axis of ``n_data`` ranks (default: every process).

    ``devices`` lists the devices of this host's ranks, by local rank:
    every visible card by default, else the CPU once per process. The job
    holds that many devices on each host (hosts: the world size over
    ``LOCAL_WORLD_SIZE``, which ``torchrun`` and an explicit-address
    ``init_multihost`` set; one host without it), and this process takes
    the device of its local rank (``LOCAL_RANK``, else its rank). The data
    axis must span the job: one process per rank. On a card, the rank's
    card becomes the current device here, before any kernel launches.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_data = world if n_data is None else n_data
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")] * max(world, n_data))
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    check_mesh_size(n_data, n_space, len(devices) * hosts)
    if n_data != world:
        raise ValueError(f"a data axis of {n_data} needs {n_data} processes, this job has "
                         f"{world}: start it with --mesh-data {n_data} or torchrun")
    device = devices[_local_rank(rank)]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, world, device, dist.group.WORLD if world > 1 else None)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """This rank's contiguous rows of each global-batch array (None stays None).

    The rows JAX's ``shard_batch_arrays`` places on data-axis index ``rank``.
    """
    return tuple(None if a is None else a[mesh.rows(len(a))] for a in arrays)


def global_batch_from_local(mesh: Mesh, *arrays):
    """The identity: each process already computes on its local rows."""
    return tuple(arrays)


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Make every rank's parameters and buffers rank 0's (in place); returns ``module``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t, src=0, group=mesh.group)
    return module


def global_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over ``group`` with autograd: the backward sums the ranks' gradients.

    So a value computed from it is the global batch's on every rank, and
    each rank's backward carries the gradient of every rank's copy of it:
    DDP's average over the ranks then gives the global batch's gradient,
    with no scaling by the world size anywhere. ``group`` None: ``t``.
    """
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, forward and backward (the gradient of a sum is the sum of gradients)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_count(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` (counts, metric sums; no gradient) summed over ``group``, as a new tensor."""
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every rank (a path, a float, None)."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def _worker(rank: int, fn: Callable, init_method: str, world: int, backend: str,
            threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    init_multihost(init_method, world, rank, backend)
    fn(rank, *args)
    # Only after success: a rank that raised exits at once, so its error
    # reaches the launcher, instead of waiting in the teardown of a group
    # whose other ranks wait in a collective.
    dist.destroy_process_group()


def launch_local(fn: Callable, nprocs: int, args: tuple = (), backend: str = "gloo",
                 timeout_s: float | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes joined in one job on this host.

    The workers start by ``spawn`` (``fn`` and ``args`` are pickled) and
    meet through a file store in a fresh temporary directory, so no port
    is taken. Each uses this process's intra-op threads split among them.
    A worker's failure ends the others and is raised here; so is
    ``timeout_s`` running out, after the workers are killed.
    """
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="rendezvous-")
    threads = max(1, torch.get_num_threads() // nprocs)
    ctx = mp.start_processes(
        _worker, args=(fn, f"file://{os.path.join(tmp, 'store')}", nprocs, backend, threads,
                       args),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} workers did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
