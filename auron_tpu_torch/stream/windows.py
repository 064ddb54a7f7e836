"""Event-time windows and watermarks (port of
``auron_tpu/stream/windows.py``).

Window assignment is a pure vectorized function of the event-time
column: every row maps to the window start(s) containing it, in
epoch-milliseconds. TUMBLE(ts, size) partitions time; HOP(ts, slide,
size) assigns each row to ``size/slide`` overlapping windows (size must
be a multiple of slide — anything else silently double-counts
boundaries, so it is refused at lowering).

The watermark is the stream's completeness claim: after observing event
time ``t``, no record older than ``t - delay`` is expected. It is
monotone (late max-timestamps never retract it) and drives emission —
a window [start, start+size) closes when ``watermark >= start + size``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_UNIT_MS = {
    "millisecond": 1,
    "second": 1000,
    "minute": 60_000,
    "hour": 3_600_000,
    "day": 86_400_000,
}


def interval_ms(n: int, unit: str) -> int:
    """INTERVAL '<n>' <unit> in milliseconds (parser-normalized units)."""
    return int(n) * _UNIT_MS[unit]


@dataclass(frozen=True)
class WindowSpec:
    """Tumbling (slide == size) or hopping event-time window, ms."""

    size_ms: int
    slide_ms: int

    @classmethod
    def tumbling(cls, size_ms: int) -> "WindowSpec":
        return cls(size_ms, size_ms)

    @classmethod
    def hopping(cls, slide_ms: int, size_ms: int) -> "WindowSpec":
        return cls(size_ms, slide_ms)

    @property
    def windows_per_row(self) -> int:
        return self.size_ms // self.slide_ms

    def assign(self, ts_ms: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(row_idx, window_start) pairs — rows expand to every window
        containing them. Tumbling is the k==1 special case of the same
        arithmetic, so both paths share one deterministic code shape."""
        ts = np.asarray(ts_ms, dtype=np.int64)
        k = self.windows_per_row
        # newest window containing ts starts at floor(ts/slide)*slide;
        # the k-1 earlier slides may also contain it (hop overlap)
        newest = (ts // self.slide_ms) * self.slide_ms
        rows = np.repeat(np.arange(len(ts), dtype=np.int64), k)
        starts = (newest[:, None]
                  - np.arange(k, dtype=np.int64)[None, :] * self.slide_ms
                  ).reshape(-1)
        keep = ts[rows] < starts + self.size_ms
        return rows[keep], starts[keep]


class WatermarkTracker:
    """Monotone event-time watermark: max(observed ts) - delay."""

    def __init__(self, delay_ms: int, watermark_ms: int | None = None):
        self.delay_ms = int(delay_ms)
        # None = nothing observed yet (no window may close)
        self.watermark_ms = watermark_ms

    def observe(self, ts_ms: np.ndarray) -> int | None:
        if len(ts_ms):
            wm = int(np.max(ts_ms)) - self.delay_ms
            if self.watermark_ms is None or wm > self.watermark_ms:
                self.watermark_ms = wm
        return self.watermark_ms
