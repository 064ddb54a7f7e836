"""Per-operator metric tree (port of ``auron_tpu/exec/metrics.py``):
every operator owns a node with named counters and nanosecond timers; the
tree mirrors the plan and is handed back at task finalize. A fused stage
(``plan/fusion.py``) splits its program's wall back into one child node per
constituent operator (``add_split``), so the timers keep naming FilterExec,
ProjectExec, HashAggExec, the join and the writer.

Every timer interval, and every share of a split, is also handed to the
span timeline (``obs.note_op``) with the same nanoseconds, so the
span-derived and the metric-derived per-operator totals agree by
construction (``obs.Trace.op_seconds_skew``)."""

from __future__ import annotations

import time
from contextlib import contextmanager

from auron_tpu_torch import obs


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

    def set(self, metric: str, value: int) -> None:
        self.values[metric] = int(value)

    #: metric-name suffixes that mean "wall nanos from timer()"; the
    #: per-operator time rankings read every metric that ends in one
    TIME_SUFFIXES = ("_time", "_nanos", "_s", "elapsed_compute")

    #: timers that run NESTED inside another timer above (merge_path_s
    #: ticks inside merge_time): rendered normally, but excluded from
    #: per-op time totals or their nanos would count twice
    NESTED_TIMERS = frozenset({"merge_path_s"})

    @staticmethod
    def op_seconds(metrics: dict) -> float:
        """Total timer seconds for one operator's metric dict (nested
        sub-timers excluded exactly once, here)."""
        return sum(
            v for m, v in metrics.items()
            if m.endswith(MetricNode.TIME_SUFFIXES)
            and m not in MetricNode.NESTED_TIMERS
        ) / 1e9

    @contextmanager
    def timer(self, metric: str, count: bool = False):
        """Accumulate host wall nanos into ``metric`` (work enqueued on the
        card is not waited for: these are host-side times); with ``count``
        also bump ``{metric}_n``. The same nanos go to ``obs.note_op``."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t0
            self.add(metric, dt)
            if count:
                self.add(metric + "_n", 1)
            obs.note_op(self.name, metric, dt)

    def add_split(self, metric: str, nanos: int, shares: list[tuple["MetricNode", int]]) -> None:
        """Add ``nanos`` to ``metric`` of the (node, weight) pairs, in
        proportion to the weights; the last node takes the rounding rest.
        Each share also goes to ``obs.note_op`` under its node's name."""
        total_w = sum(w for _, w in shares) or 1
        spent = 0
        for i, (node, w) in enumerate(shares):
            part = nanos - spent if i == len(shares) - 1 else nanos * w // total_w
            spent += part
            node.add(metric, part)
            obs.note_op(node.name, metric, part)

    def snapshot(self) -> dict:
        """Flatten to {name, values, children} for the bridge. Never raises
        under concurrent mutation (an observer such as ``/metrics``
        snapshots a live task's tree while its operators add to it)."""
        vals = None
        for _ in range(1000):
            try:
                vals = dict(self.values)
                break
            except RuntimeError:
                continue
        if vals is None:  # pragma: no cover — 1000 straight collisions
            vals = {}
        return {
            "name": self.name,
            "values": vals,
            "children": [c.snapshot() for c in list(self.children)],
        }

    def total(self, metric: str) -> int:
        return self.values.get(metric, 0) + sum(c.total(metric) for c in self.children)

    @staticmethod
    def flat_totals(snapshot: dict) -> dict[str, int]:
        """Per-metric totals across a snapshot() tree (the rollup a host
        engine's metric registry consumes)."""
        out: dict[str, int] = {}

        def rec(node: dict) -> None:
            for k, v in node.get("values", {}).items():
                out[k] = out.get(k, 0) + int(v)
            for c in node.get("children", ()):
                rec(c)

        rec(snapshot)
        return out

    @staticmethod
    def accumulate_op_totals(snapshot: dict, into: dict) -> None:
        """Fold a snapshot() tree into a per-OPERATOR metric rollup (op
        name = node name with the per-instance ``.N`` suffix stripped)."""

        def rec(node: dict) -> None:
            op = (node.get("name") or "<node>").split(".")[0]
            tot = into.setdefault(op, {})
            for k, v in node.get("values", {}).items():
                tot[k] = tot.get(k, 0) + int(v)
            for c in node.get("children", ()):
                rec(c)

        rec(snapshot)

    def render(self, indent: int = 0) -> str:
        """Human-readable metric tree."""

        def fmt(k: str, v: int) -> str:
            if k.endswith(MetricNode.TIME_SUFFIXES):
                return f"{k}={v / 1e6:.1f}ms"
            return f"{k}={v}"

        vals = " ".join(fmt(k, v) for k, v in sorted(self.values.items()))
        lines = ["  " * indent + (self.name or "<node>") + (": " + vals if vals else "")]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)
