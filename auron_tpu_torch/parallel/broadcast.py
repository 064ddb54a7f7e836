"""AQE partition statistics (port of ``auron_tpu/parallel/broadcast.py:63-90``).

The shuffle writer's index files are the map output sizes (Spark's
MapStatus): ``map_output_sizes`` reads the [map, reduce partition] byte
matrix (AQE skew splitting slices a partition by map ranges; its column
sums are ``map_output_stats``'s per-partition totals), and
``plan_coalesced_partitions`` groups adjacent small reduce partitions up to
a target size (Spark's CoalesceShufflePartitions). The broadcast exchange
halves of that module wait for a later slice.
"""

from __future__ import annotations

import numpy as np

from auron_tpu_torch.exec.shuffle.format import read_index_tagged


def map_output_sizes(index_files: list[str], n_parts: int) -> np.ndarray:
    """[map task, reduce partition] output bytes."""
    if not index_files:
        return np.zeros((0, n_parts), np.int64)
    return np.stack([np.diff(np.asarray(read_index_tagged(f)[0], dtype=np.int64))
                     for f in index_files])


def plan_coalesced_partitions(partition_bytes: np.ndarray,
                              target_bytes: int) -> list[list[int]]:
    """AQE post-shuffle coalescing: group adjacent small reduce partitions
    until each group reaches ~target_bytes."""
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for p, sz in enumerate(partition_bytes.tolist()):
        cur.append(p)
        cur_bytes += sz
        if cur_bytes >= target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    return groups
