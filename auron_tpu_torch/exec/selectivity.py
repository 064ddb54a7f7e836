"""Selectivity prediction for sync-free compaction-bucket choice (a copy
of ``auron_tpu/exec/selectivity.py``; only its imports point at the port).

The compaction boundaries (fused join chain, BHJ unique-compact) used to
block on a read of the selection every batch just to learn the live count
and pick an output capacity bucket. Steady-state selectivity is highly
autocorrelated across batches of one stream, so the bucket is *predictable*:

- ``SelectivityPredictor`` keeps an EWMA of observed live counts and
  predicts the next batch's compacted capacity bucket with a headroom
  multiplier (absorbs noise) and shrink hysteresis (a bucket only shrinks
  after ``patience`` consecutive low-demand batches, so oscillating
  selectivity doesn't thrash shapes);
- the consumer compacts INTO the predicted bucket entirely on device
  (``columnar.batch.compaction_index``) and reads the actual live count
  asynchronously k batches later (``runtime/transfer.TransferWindow``);
- a mispredict (live count exceeded the bucket: rows were truncated) is
  detected at harvest time, *before* the batch is emitted downstream, and
  repaired by re-gathering at the correct bucket from the still-held
  device state — results are bit-identical to the blocking path.

The first batch of a stream has no history and takes the classic blocking
path (one sync per stream, not per batch).
"""

from __future__ import annotations

from auron_tpu_torch.columnar.batch import bucket_capacity
from auron_tpu_torch.utils.config import (
    JOIN_COMPACT_OUTPUT,
    SELECTIVITY_EWMA_ALPHA,
    SELECTIVITY_HEADROOM,
    SELECTIVITY_PREDICTOR_ENABLE,
    SELECTIVITY_SHRINK_PATIENCE,
    resolve_tri,
)


def predictor_enabled(conf) -> bool:
    """Knob resolution: on | off | auto (= on wherever compaction runs —
    the predictor only exists to unblock the compaction boundary)."""
    compacting = resolve_tri(conf.get(JOIN_COMPACT_OUTPUT), True)
    return resolve_tri(conf.get(SELECTIVITY_PREDICTOR_ENABLE), compacting)


class SelectivityPredictor:
    """EWMA live-count tracker -> predicted compaction capacity bucket.

    ``observe`` feeds every batch's actual live count; ``predict`` returns
    the capacity bucket the next batch should compact into, or None before
    the first observation (caller takes the blocking path once).
    Growth is immediate (an overflow already cost a repair — never two);
    shrinking waits out ``patience`` consecutive low batches."""

    def __init__(self, conf=None):
        from auron_tpu_torch.utils.config import active_conf

        c = conf if conf is not None else active_conf()
        self.alpha = min(max(c.get(SELECTIVITY_EWMA_ALPHA), 0.01), 1.0)
        self.headroom = max(c.get(SELECTIVITY_HEADROOM), 1.0)
        self.patience = max(c.get(SELECTIVITY_SHRINK_PATIENCE), 1)
        self.ewma: float | None = None
        self._bucket: int | None = None
        self._low_streak = 0
        # counters surfaced in operator metrics / tests
        self.predictions = 0
        self.mispredicts = 0

    def predict(self, in_capacity: int) -> int | None:
        """Predicted live-count capacity bucket for the next batch, or None
        before the first observation (the caller then takes the blocking
        path once to seed the EWMA). The caller applies the shared
        ``compaction_bucket`` threshold to decide compact-vs-dense — a
        dense prediction still emits WITHOUT a sync."""
        if self._bucket is None:
            return None
        self.predictions += 1
        return min(self._bucket, bucket_capacity(max(in_capacity, 1)))

    def observe(self, n_live: int, predicted: int | None = None) -> None:
        """Feed one batch's actual live count. ``predicted`` is the bucket
        the batch was compacted into (None = blocking/dense path) — an
        overflow there counts as a mispredict."""
        if predicted is not None and n_live > predicted:
            self.mispredicts += 1
        self.ewma = (
            float(n_live)
            if self.ewma is None
            else self.alpha * n_live + (1.0 - self.alpha) * self.ewma
        )
        want = bucket_capacity(max(int(self.ewma * self.headroom), n_live, 1))
        if self._bucket is None or want > self._bucket:
            self._bucket = want          # grow immediately
            self._low_streak = 0
        elif want <= self._bucket // 2:
            self._low_streak += 1        # shrink with hysteresis
            if self._low_streak >= self.patience:
                self._bucket = max(want, bucket_capacity(1))
                self._low_streak = 0
        else:
            self._low_streak = 0
