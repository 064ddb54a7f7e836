"""The logical partition mesh of the planned exchange.

Port of ``auron_tpu/parallel/mesh.py:26-31``. The JAX package lays one
partition executor on each chip of a 1-D mesh with axis ``"p"``; the port
stacks logical partitions on ONE device per process, on a leading
``[P, ...]`` axis of its tensors. A one-process mesh (``make_mesh``) holds
all ``n_parts`` partitions on its device. A multi-process mesh
(``multihost.global_mesh``) spans ``process_count`` processes, each owning
the contiguous block ``local_parts`` of ``n_parts / process_count``
partitions on its own device; with more than one process its exchanges
ride ``torch.distributed`` (``parallel/exchange.py``).

``shard_spec``, ``replicated_spec`` and ``shard_rows`` (``mesh.py:33-46``)
have no counterpart: they are JAX sharding specs and a ``device_put`` onto
them, while the port's partitions of one process are slices of one stacked
tensor on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch.device import resolve_device

PARTITION_AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """``n_parts`` logical partitions: all on ``device`` in one process, or
    ``n_parts / process_count`` of them on this process's ``device``."""

    n_parts: int
    device: torch.device
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.n_parts % self.process_count:
            raise ValueError(f"{self.n_parts} partitions do not split evenly over "
                             f"{self.process_count} processes")

    @property
    def shape(self) -> dict[str, int]:
        return {PARTITION_AXIS: self.n_parts}

    @property
    def parts_per_process(self) -> int:
        return self.n_parts // self.process_count

    @property
    def local_parts(self) -> list[int]:
        """The global partition ids this process owns, in order."""
        lo = self.process_index * self.parts_per_process
        return list(range(lo, lo + self.parts_per_process))


def make_mesh(n_parts: int, device="cuda") -> Mesh:
    """A one-process mesh of ``n_parts`` partitions on ``device`` (cuda
    raises without a card)."""
    if n_parts < 1:
        raise ValueError(f"a mesh needs at least one partition, got {n_parts}")
    return Mesh(int(n_parts), resolve_device(device))
