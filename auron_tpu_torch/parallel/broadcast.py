"""AQE partition statistics (port of ``auron_tpu/parallel/broadcast.py:63-90``).

The shuffle writer's index files are the map output sizes (Spark's
MapStatus); ``map_output_stats`` sums them per reduce partition and
``plan_coalesced_partitions`` groups adjacent small reduce partitions up to
a target size (Spark's CoalesceShufflePartitions). The broadcast exchange
halves of that module wait for a later slice.
"""

from __future__ import annotations

import numpy as np

from auron_tpu_torch.exec.shuffle.format import read_index_tagged


def map_output_stats(index_files: list[str]) -> np.ndarray:
    """Per-reduce-partition output bytes summed over all map tasks."""
    totals: np.ndarray | None = None
    for f in index_files:
        offsets = np.asarray(read_index_tagged(f)[0], dtype=np.int64)
        sizes = offsets[1:] - offsets[:-1]
        totals = sizes if totals is None else totals + sizes
    return totals if totals is not None else np.zeros(0, np.int64)


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
