"""k-deep asynchronous device->host transfer window (port of
``auron_tpu/runtime/transfer.py``).

The engine's residual host reads (compaction live counts, dense-agg fold
flags, shuffle counts) are small transfers whose cost is the stall, not
the bytes: a blocking read waits for the device work producing the value.
The window takes that stall off the critical path:

- ``start_host_transfer`` starts a ``copy_(src, non_blocking=True)`` of
  each CUDA tensor into a **pinned** host tensor (a copy into pageable
  memory would not be asynchronous), or of a small batch of them gathered
  into one buffer (``PACK_BYTES``), and records one ``torch.cuda.Event``
  on the current stream behind the copies. Pinned tensors come from
  PyTorch's caching host allocator, which reuses freed blocks, so a batch
  does not pay a ``cudaHostAlloc``. A CPU tensor is not copied at all;
- the value is *harvested* k batches later (``TransferWindow``), by which
  time the copy has ridden behind k batches of device work. A harvest
  waits on the event; reading the pinned tensor before the event would
  return garbage.

Reads are counted in the caller's metric node: ``async_reads`` (the event
had completed, or the tensor lay on the CPU), ``waited_reads`` (a harvest
inside the stream whose event had not completed: the card was more than
the window behind the host, which a slower device or a busy host decides,
not the code), ``drain_waits`` (an end-of-stream harvest that had to wait
for the stream's last batches) and ``blocking_reads`` (the reads the code
chose to block on: ``blocking_read``, the callers' seed and repair reads).

These are the port's read points for ``utils/profiling.EngineCounters``
and the span timeline: a blocking read and a harvest that waited are host
syncs, a harvest that did not wait an async read. ``push`` captures the
pushing thread's span and a harvest installs it, so a harvest run on
another thread (a drain on a spill thread) attributes to the owning
task's trace (``obs.note_transfer_start``, ``note_harvest``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterator

import numpy as np
import torch

from auron_tpu_torch import obs
from auron_tpu_torch.runtime import dispatch
from auron_tpu_torch.utils.profiling import note_read


class HostTransfer:
    """One batch's started copies: the host tensors and the event behind them."""

    __slots__ = ("host", "event")

    def __init__(self, host: tuple, event):
        self.host = host
        self.event = event


#: the most bytes a transfer of several CUDA tensors gathers into one copy
#: (and ``Batch.from_host_arrow`` stages as one): below it a copy's fixed
#: cost outweighs moving the bytes twice on the device; above it the
#: tensors keep copies of their own
PACK_BYTES = 1 << 20


def start_host_transfer(*tensors: torch.Tensor) -> HostTransfer:
    """Start non-blocking copies of the CUDA tensors into pinned host
    memory, under one event; CPU tensors pass through uncopied. Several
    CUDA tensors of at most ``PACK_BYTES`` together are gathered into one
    device buffer (one ``torch.cat``, the widest elements first so every
    view stays aligned) and copied into one pinned buffer, of which the
    host values are numpy views; else each has its own pinned tensor."""
    obs.note_transfer_start(len(tensors))
    cuda = [i for i, t in enumerate(tensors) if t.device.type == "cuda"]
    if not cuda:
        return HostTransfer(tuple(tensors), None)
    host = list(tensors)
    if len(cuda) > 1 and all(tensors[i].dtype in _NUMPY_DTYPE for i in cuda) and sum(
            tensors[i].numel() * tensors[i].element_size() for i in cuda) <= PACK_BYTES:
        order = sorted(cuda, key=lambda i: -tensors[i].element_size())
        flat = [flat_bytes(tensors[i]) for i in order]
        pinned = torch.empty(sum(len(f) for f in flat), dtype=torch.uint8, pin_memory=True)
        pinned.copy_(torch.cat(flat), non_blocking=True)
        h, off = pinned.numpy(), 0
        for i, f in zip(order, flat):
            t = tensors[i]
            host[i] = h[off:off + len(f)].view(_NUMPY_DTYPE[t.dtype]).reshape(t.shape)
            off += len(f)
    else:
        for i in cuda:
            host[i] = torch.empty(tensors[i].shape, dtype=tensors[i].dtype, pin_memory=True)
            host[i].copy_(tensors[i], non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[cuda[0]].device))
    return HostTransfer(tuple(host), event)


#: numpy dtypes of the torch dtypes a gathered transfer reads
_NUMPY_DTYPE = {t: np.dtype(d) for t, d in (
    (torch.bool, np.bool_), (torch.int8, np.int8), (torch.uint8, np.uint8),
    (torch.int16, np.int16), (torch.int32, np.int32), (torch.int64, np.int64),
    (torch.float32, np.float32), (torch.float64, np.float64))}


def flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a view of a contiguous vector,
    the batches' planes)."""
    if t.dim() == 1 and t.is_contiguous():
        return t.view(torch.uint8)
    return t.contiguous().view(-1).view(torch.uint8)


def harvest(tr: HostTransfer, metrics=None, waited_counter: str = "waited_reads",
            yield_turn: bool = False) -> tuple[np.ndarray, ...]:
    """Resolve a started transfer to host numpy values. Counts one
    ``async_reads`` when its event had completed (or nothing was copied),
    else one ``waited_counter`` after waiting on the event. ``yield_turn``:
    the caller holds no lock that another thread's dispatch could need, so
    a wait gives the host's turn up (``runtime/dispatch.py``)."""
    t0 = time.perf_counter_ns()
    waited = tr.event is not None and not tr.event.query()
    turn_ns = 0  # taking the turn back is a lock wait, not the read's
    if waited:
        if yield_turn:
            with dispatch.waiting():
                tr.event.synchronize()
                t_back = time.perf_counter_ns()
            turn_ns = time.perf_counter_ns() - t_back
        else:
            tr.event.synchronize()
    if metrics is not None:
        metrics.add(waited_counter if waited else "async_reads", 1)
    out = tuple(h if isinstance(h, np.ndarray) else h.numpy() for h in tr.host)
    dt = time.perf_counter_ns() - t0 - turn_ns
    note_read(dt / 1e9, is_async=not waited)
    obs.note_harvest(len(out), dt)
    return out


def blocking_read(metrics, *tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """A read that the caller waits for at once (a seed or a repair read):
    counted in ``blocking_reads``, and a host sync of the engine counters."""
    if metrics is not None:
        metrics.add("blocking_reads", 1)
    t0 = time.perf_counter()
    out = tuple(t.cpu().numpy() for t in tensors)
    note_read(time.perf_counter() - t0, is_async=False)
    return out


def tensor_bytes(*items) -> int:
    """Device bytes of the tensors among ``items`` (nested tuples/lists)."""
    n = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += tensor_bytes(*x)
    return n


class TransferWindow:
    """FIFO of in-flight (transfer, payload) entries, at most ``depth`` deep.

    ``push`` starts the transfers and returns the entries that fell out of
    the window (resolved, oldest first); ``drain`` resolves the rest at
    the end of the stream; ``clear`` drops every entry unread (a consumer
    that stops early). Depth 1 is the classic one-deep software pipeline
    (dispatch i+1, then finish i). ``nbytes`` is the device state the
    entries hold, as the pushers declared it (``WindowGuard`` reports it
    to the memory manager)."""

    def __init__(self, depth: int, metrics=None):
        self.depth = max(1, int(depth))
        self.metrics = metrics
        self.nbytes = 0
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, tensors: tuple, payload: Any, nbytes: int = 0) -> list[tuple[tuple, Any]]:
        # the pushing thread's span (mode off keeps this path bare): the
        # harvest may run on whichever thread drains
        sp = obs.current_span() if obs.core._mode != obs.MODE_OFF else None
        self._q.append((start_host_transfer(*tensors), payload, nbytes, sp))
        self.nbytes += nbytes
        out = []
        while len(self._q) > self.depth:
            out.append(self._pop("waited_reads"))
        return out

    def _pop(self, waited_counter: str) -> tuple[tuple, Any]:
        tr, payload, nbytes, sp = self._q.popleft()
        self.nbytes -= nbytes
        if obs.core._mode == obs.MODE_OFF:
            return harvest(tr, self.metrics, waited_counter), payload
        with obs.use_span(sp):
            return harvest(tr, self.metrics, waited_counter), payload

    def drain(self) -> Iterator[tuple[tuple, Any]]:
        while self._q:
            yield self._pop("drain_waits")

    def clear(self) -> None:
        self._q.clear()
        self.nbytes = 0


class WindowGuard:
    """Accounting-only memory consumer for a window's in-flight device
    state: registered unspillable, its bytes shrink the pool the spillable
    consumers share; ``spill()`` frees nothing."""

    def __init__(self, name: str, *windows):
        self.name = name
        self.windows = windows

    def mem_used(self) -> int:
        return sum(w.nbytes for w in self.windows)

    def spill(self) -> int:
        return 0

    def release(self) -> None:
        """Drop the windows' entries (a stream abandoned before its end)."""
        for w in self.windows:
            w.clear()
