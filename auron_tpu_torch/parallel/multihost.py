"""Multi-process runtime initialization on ``torch.distributed``.

Port of ``auron_tpu/parallel/multihost.py``. The JAX package joins every
host's devices into one global mesh with ``jax.distributed`` and lets XLA
partition its collectives. Here every process owns one device and a
contiguous block of ``L`` logical partitions stacked on it (as one process
stacks all of them, ``parallel/mesh.py``), so a global mesh of ``P = world
x L`` partitions gives process ``r`` partitions ``[r L, (r + 1) L)``.

Environment contract (the JAX package's own):

  AURON_COORDINATOR   host:port of process 0 (its TCP store)
  AURON_NUM_PROCS     total process count
  AURON_PROC_ID       this process's index
  AURON_DIST_BACKEND  optional: ``nccl`` | ``gloo``, the data plane's backend

Two process groups:

- the **control plane**, a ``gloo`` group for host-level allgathers and
  barriers (routing counts, vocabularies, the shared-work_dir probe): the
  counterpart of ``jax.experimental.multihost_utils``; it never touches a
  card;
- the **data plane**, the default group, which carries the exchange's rows
  (``parallel/exchange.py``): ``nccl`` when every rank owns a card of its
  own (the default for a CUDA device), ``gloo`` when asked for (the default
  for ``cpu``; two ranks sharing one card need it, since NCCL refuses two
  ranks on one device). The backend is never switched on failure.

Every group has a bounded timeout, so a rank that raises before a
collective leaves its peers failing instead of waiting forever. On one
process without ``AURON_COORDINATOR`` nothing is initialized and
``initialize_from_env`` returns False, as the JAX package does.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from auron_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from auron_tpu_torch.parallel.mesh import Mesh

#: seconds a collective of either group may wait for its peers
DEFAULT_TIMEOUT_S = 300.0

_state: dict = {}


def initialize_from_env(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group named by the ``AURON_*`` environment; False
    (and nothing joined) without ``AURON_COORDINATOR``. ``device`` (default
    the package's) picks the data plane's default backend: ``nccl`` for
    ``cuda``, ``gloo`` for ``cpu``; ``AURON_DIST_BACKEND`` overrides it."""
    import torch.distributed as dist

    if _state:
        return True
    coord = os.environ.get("AURON_COORDINATOR")
    if not coord:
        return False
    world = int(os.environ["AURON_NUM_PROCS"])
    rank = int(os.environ["AURON_PROC_ID"])
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    backend = os.environ.get("AURON_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"AURON_DIST_BACKEND must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl data plane needs a CUDA device")
        # NCCL binds the rank to the current device
        torch.cuda.set_device(_rank_device(dev, rank))
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world,
                            rank=rank, timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    _state.update(rank=rank, world=world, backend=backend, control=control)
    return True


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def process_info() -> tuple[int, int]:
    """(this process's rank, process count); (0, 1) when not initialized."""
    if not _state:
        return 0, 1
    return _state["rank"], _state["world"]


def backend() -> str | None:
    """The data plane's backend (None when not initialized)."""
    return _state.get("backend")


def control_group():
    """The gloo group of host-level allgathers and barriers."""
    _require()
    return _state["control"]


def data_group():
    """The group that carries the exchange's rows (the default group)."""
    import torch.distributed as dist

    _require()
    return dist.group.WORLD


def _require() -> None:
    if not _state:
        raise RuntimeError("torch.distributed is not initialized: call "
                           "multihost.initialize_from_env() with the AURON_* environment")


def global_mesh(parts_per_process: int, device=None) -> Mesh:
    """The mesh of ``world x parts_per_process`` partitions across every
    process; this process owns the contiguous block of its rank on
    ``device`` (default ``cuda:{rank % device_count}``; a CUDA request
    without a card raises)."""
    _require()
    if parts_per_process < 1:
        raise ValueError(f"a process needs at least one partition, got {parts_per_process}")
    rank, world = process_info()
    dev = _rank_device(resolve_device(device), rank)
    return Mesh(world * int(parts_per_process), dev, process_index=rank, process_count=world)


def shutdown() -> None:
    """Destroy the control plane and the default group."""
    import torch.distributed as dist

    if not _state:
        return
    try:
        dist.destroy_process_group(_state["control"])
        dist.destroy_process_group()
    finally:
        _state.clear()


# ---------------------------------------------------------------------------
# host-level collectives on the control plane
# ---------------------------------------------------------------------------


def allgather_array(a: np.ndarray) -> np.ndarray:
    """Every rank's numpy array of one shape and dtype, stacked in rank
    order as ``[world, *a.shape]`` (one gloo allgather)."""
    import torch.distributed as dist

    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.uint8).reshape(-1).copy())
    _, world = process_info()
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t, group=control_group())
    return np.stack([o.numpy().view(a.dtype).reshape(a.shape) for o in out])


def allgather_bytes(blob: bytes) -> list[bytes]:
    """Every rank's bytes in rank order: two allgathers (the lengths, then
    the payloads padded to the longest)."""
    lengths = allgather_array(np.array([len(blob)], dtype=np.int64)).reshape(-1)
    buf = np.zeros(max(int(lengths.max()), 1), dtype=np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    gathered = allgather_array(buf)
    return [gathered[r, : int(n)].tobytes() for r, n in enumerate(lengths)]


def barrier() -> None:
    """A barrier on the control plane."""
    import torch.distributed as dist

    dist.barrier(group=control_group())
