"""Page-locked staging of the predict call's host<->card copies.

A copy from or to pageable host memory makes the CUDA driver stage it
through its own page-locked buffer on the calling thread, one plain memcpy
at a time, and ``.cpu()`` writes into a freshly mapped array besides, whose
pages fault in during the copy: the predict cells' 88.5 MB upload and 59 MB
download of a batch of 32 at 480^2 ran at 5.3 and 2.4 GB/s on an H100's
host (PERF.md §5). Here each device has, per direction, a ring of ``SLOTS``
page-locked slots of ``CHUNK_BYTES``, each with the event of its last DMA,
and a batch moves in chunks of whole images (``chunks``):

- ``upload(images, device)``: for each chunk, wait until a slot's last DMA
  is done, copy the chunk into it on the host (``torch``'s multi-threaded
  ``copy_``), then a ``non_blocking`` DMA into the chunk's slice of the
  device input and the slot's event. The host copy of chunk k + 1 runs
  while chunk k's DMA does.
- ``download(probs)``: DMAs of the chunks into the slots, each followed by
  its event; as each lands, the host copies it into a fresh pageable
  ``np.empty`` result while the next chunk's DMA runs. The caller owns that
  array: no page-locked memory leaves a call, and no two calls' results
  share memory.

The result's page faults cost about as much as the copies themselves. So
once an upload is staged, if the device's last download had the same
images (N, H, W), a worker thread makes the next result ahead (``_fresh``:
``np.empty`` with every page written once) while the caller's thread
launches the forward and waits for it, and ``download`` takes it when its
shape is the one asked for; otherwise its copies fault the pages of a
plain ``np.empty``. At most one such result waits per device.

Both directions run on the device's current stream, so the forward and the
softmax keep their order against them. The bytes are copied as they are:
the results equal ``.to(device)`` and ``.cpu().numpy()`` bit for bit.
Held: 2 directions x ``SLOTS`` x ``CHUNK_BYTES`` (128 MiB) page-locked per
device, pinned at the device's first call; a slot grows only to hold one
image larger than a chunk. A lock per ring lets threads share a device.
Counters: ``upload.staged_uploads`` and ``download.staged_downloads`` count
calls through the slots, ``upload.staging_allocs`` and
``download.staging_allocs`` the slots pinned or grown,
``download.made_ahead`` the results that were made ahead.
"""

from __future__ import annotations

import collections
import concurrent.futures
import mmap
import threading

import numpy as np
import torch

CHUNK_BYTES = 32 << 20  # the card's probe and runs at 480^2, batch 32 (PERF.md §6)
SLOTS = 2


def chunks(n: int, item_bytes: int, chunk_bytes: int = CHUNK_BYTES) -> list[tuple[int, int]]:
    """[start, end) ranges of whole items covering ``range(n)`` in order, each at most
    ``chunk_bytes`` of items of ``item_bytes`` and at least one item."""
    per = max(1, chunk_bytes // max(1, item_bytes))
    return [(i, min(i + per, n)) for i in range(0, n, per)]


class Ring:
    """``slots`` page-locked buffers of ``chunk_bytes`` and each one's last DMA's event."""

    def __init__(self, chunk_bytes: int = CHUNK_BYTES, slots: int = SLOTS):
        self.chunk_bytes = chunk_bytes
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(slots)]
        self.events = [torch.cuda.Event() for _ in range(slots)]
        self.allocs = slots
        self.turn = 0
        self.lock = threading.Lock()

    def take(self, nbytes: int) -> tuple[torch.Tensor, torch.cuda.Event]:
        """The next slot in turn as ``nbytes`` bytes, once its last DMA is done, and its event."""
        k = self.turn
        self.turn = (k + 1) % len(self.bufs)
        self.events[k].synchronize()
        if self.bufs[k].numel() < nbytes:
            self.bufs[k] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.allocs += 1
        return self.bufs[k][:nbytes], self.events[k]


def stage_upload(ring: Ring, src: torch.Tensor, out: torch.Tensor) -> None:
    """Copy host ``src`` into device ``out`` (same shape) through ``ring``'s slots."""
    stream = torch.cuda.current_stream(out.device)
    item = out[0].numel() * out.element_size() if len(out) else 0
    for i0, i1 in chunks(len(out), item, ring.chunk_bytes):
        buf, done = ring.take((i1 - i0) * item)
        slot = buf.view(out.dtype).view(out[i0:i1].shape)
        slot.copy_(src[i0:i1])
        out[i0:i1].copy_(slot, non_blocking=True)
        done.record(stream)


def stage_download(ring: Ring, src: torch.Tensor, out: torch.Tensor) -> None:
    """Copy device ``src`` into host ``out`` (same shape) through ``ring``'s slots."""
    stream = torch.cuda.current_stream(src.device)
    item = out[0].numel() * out.element_size() if len(out) else 0
    landing = collections.deque()

    def land():
        slot, done, i0, i1 = landing.popleft()
        done.synchronize()
        out[i0:i1].copy_(slot)

    for i0, i1 in chunks(len(out), item, ring.chunk_bytes):
        if len(landing) == len(ring.bufs):
            land()
        buf, done = ring.take((i1 - i0) * item)
        slot = buf.view(out.dtype).view(out[i0:i1].shape)
        slot.copy_(src[i0:i1], non_blocking=True)
        done.record(stream)
        landing.append((slot, done, i0, i1))
    while landing:
        land()


def _fresh(shape: tuple[int, ...]) -> np.ndarray:
    """A new float32 array of ``shape`` with each of its pages written once (faulted in)."""
    out = np.empty(shape, np.float32)
    torch.from_numpy(out.reshape(-1).view(np.uint8))[::mmap.PAGESIZE].fill_(0)
    return out


_rings: dict[tuple[torch.device, str], Ring] = {}
_last_shape: dict[torch.device, tuple[int, ...]] = {}  # each device's last download's shape
_ahead: dict[torch.device, tuple[tuple[int, ...], concurrent.futures.Future]] = {}
_worker = concurrent.futures.ThreadPoolExecutor(1, "host_copy")  # its thread starts at first use
_lock = threading.Lock()  # guards the dicts above and the counters


def _ring(fn, device: torch.device) -> Ring:
    """``device``'s ring of the transfer function ``fn``, pinned at its first call."""
    with _lock:
        ring = _rings.get((device, fn.__name__))
        if ring is None:
            ring = _rings[(device, fn.__name__)] = Ring()
            fn.staging_allocs += ring.allocs
        return ring


def _count(fn, calls: str, allocs: int) -> None:
    with _lock:
        setattr(fn, calls, getattr(fn, calls) + 1)
        fn.staging_allocs += allocs


def _make_ahead(device: torch.device, images: tuple[int, ...]) -> None:
    """Start making ``device``'s next result if its last download was of ``images``."""
    with _lock:
        shape = _last_shape.get(device)
        if shape is not None and shape[:3] == images[:3]:
            _ahead[device] = (shape, _worker.submit(_fresh, shape))


def _result(device: torch.device, shape: tuple[int, ...]) -> np.ndarray:
    """The result made ahead for ``device`` if it has ``shape``, else a fresh one."""
    with _lock:
        made, ahead = _ahead.pop(device, (None, None))
        _last_shape[device] = shape
        if made == shape:
            download.made_ahead += 1
    return ahead.result() if made == shape else np.empty(shape, np.float32)


def upload(images: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host NHWC images (a numpy array or a CPU tensor) as a float32 tensor on card
    ``device`` (with its index)."""
    src = torch.as_tensor(images)
    out = torch.empty(src.shape, dtype=torch.float32, device=device)
    ring = _ring(upload, device)
    with ring.lock:
        before = ring.allocs
        stage_upload(ring, src, out)
        grown = ring.allocs - before
    _count(upload, "staged_uploads", grown)
    _make_ahead(device, tuple(src.shape))
    return out


def download(probs: torch.Tensor) -> np.ndarray:
    """A float32 card tensor as a fresh C-contiguous numpy array the caller owns."""
    src = probs.contiguous()
    out = _result(src.device, tuple(src.shape))
    ring = _ring(download, src.device)
    with ring.lock:
        before = ring.allocs
        stage_download(ring, src, torch.from_numpy(out))
        grown = ring.allocs - before
    _count(download, "staged_downloads", grown)
    return out


upload.staged_uploads = 0
upload.staging_allocs = 0
download.staged_downloads = 0
download.staging_allocs = 0
download.made_ahead = 0
