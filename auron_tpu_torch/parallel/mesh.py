"""The logical partition mesh of the planned exchange on one card.

Port of ``auron_tpu/parallel/mesh.py:26-46``. The JAX package lays one
partition executor on each chip of a 1-D mesh with axis ``"p"``; the port
runs ``n_parts`` logical partitions on ONE device, stacked on a leading
``[P, ...]`` axis of its tensors. A mesh is the partition count and that
device. Partitions across several cards (``torch.distributed`` / NCCL) are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch.device import resolve_device

PARTITION_AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """``n_parts`` logical partitions on one device."""

    n_parts: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {PARTITION_AXIS: self.n_parts}


def make_mesh(n_parts: int, device="cuda") -> Mesh:
    """A mesh of ``n_parts`` partitions on ``device`` (cuda raises without
    a card)."""
    if n_parts < 1:
        raise ValueError(f"a mesh needs at least one partition, got {n_parts}")
    return Mesh(int(n_parts), resolve_device(device))
