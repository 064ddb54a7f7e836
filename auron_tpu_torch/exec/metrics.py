"""Per-operator metric tree (port of ``auron_tpu/exec/metrics.py``):
every operator owns a node with named counters and nanosecond timers; the
tree mirrors the plan and is handed back at task finalize. A fused stage
(``plan/fusion.py``) splits its program's wall back into one child node per
constituent operator (``add_split``), so the timers keep naming FilterExec,
ProjectExec, HashAggExec, the join and the writer."""

from __future__ import annotations

import time
from contextlib import contextmanager


class MetricNode:
    def __init__(self, name: str = "", children: list["MetricNode"] | None = None):
        self.name = name
        self.values: dict[str, int] = {}
        self.children: list[MetricNode] = children or []

    def child(self, i: int) -> "MetricNode":
        while len(self.children) <= i:
            self.children.append(MetricNode(f"{self.name}.{len(self.children)}"))
        return self.children[i]

    def add(self, metric: str, value: int) -> None:
        self.values[metric] = self.values.get(metric, 0) + int(value)

    @contextmanager
    def timer(self, metric: str, count: bool = False):
        """Accumulate host wall nanos into ``metric`` (work enqueued on the
        card is not waited for: these are host-side times)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(metric, time.perf_counter_ns() - t0)
            if count:
                self.add(metric + "_n", 1)

    def add_split(self, metric: str, nanos: int, shares: list[tuple["MetricNode", int]]) -> None:
        """Add ``nanos`` to ``metric`` of the (node, weight) pairs, in
        proportion to the weights; the last node takes the rounding rest."""
        total_w = sum(w for _, w in shares) or 1
        spent = 0
        for i, (node, w) in enumerate(shares):
            part = nanos - spent if i == len(shares) - 1 else nanos * w // total_w
            spent += part
            node.add(metric, part)

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "values": dict(self.values),
            "children": [c.snapshot() for c in list(self.children)],
        }
