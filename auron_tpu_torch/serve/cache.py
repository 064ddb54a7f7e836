"""Plan-digest-keyed compiled-plan cache (port of
``auron_tpu/serve/cache.py``; only the imports differ).

The top layer of the engine's reuse stack:

1. THIS cache: ``plan_digest(sql)`` + the plan-affecting session knobs
   -> a finished :class:`~auron_tpu_torch.sql.lowering.LoweredQuery`. A
   hit skips parse -> bind -> lower entirely.
2. the fusion stage cache (plan/fusion.py): (segment signature,
   capacity bucket, input shapes) -> a captured CUDA graph, shared across
   fresh task instances — so replaying a cached plan adds ZERO new graph
   captures (``models/servegate.py`` asserts it).
3. the kernel libraries, built once per source (ops/cuda_build.py).

Keying: digest equality implies plan equality only at fixed values of
the knobs the lowering actually reads, so those values are PART of the
key (``PLAN_KNOBS``). A tenant flipping ``sql.shuffle.partitions`` in
its session conf therefore never hits another tenant's entry — the
invalidation-by-construction the satellite test pins.

The LoweredQuery plan messages are treated as IMMUTABLE by every
consumer (MeshQueryDriver.run rewrites via new nodes; task_from_proto
copies) — concurrent executions share one entry safely. Bounded LRU;
eviction is count-based (entries are a few KB of plan messages, the
graphs they reference live in the layer-2 cache and survive eviction
here).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from auron_tpu_torch.sql.digest import PLAN_KNOBS
from auron_tpu_torch.utils.config import CASE_SENSITIVE, Configuration

__all__ = ["PLAN_KNOBS", "PlanCache", "plan_cache_key"]


def plan_cache_key(sql: str, conf: Configuration) -> str:
    """One hex digest covering the canonical text AND the resolved
    plan-affecting knob values — the string POST /sql reports back, so a
    tenant can SEE that its session knob moved it to a different entry."""
    import hashlib

    from auron_tpu_torch.sql.digest import plan_digest

    case_sensitive = bool(conf.get(CASE_SENSITIVE))
    digest = plan_digest(sql, fold_ident_case=not case_sensitive)
    knobs = ";".join(f"{o.key}={conf.get(o)}" for o in PLAN_KNOBS)
    return hashlib.sha256(
        f"{digest}|{knobs}".encode("utf-8")).hexdigest()[:32]


class PlanCache:
    """Bounded LRU of compiled plans; thread-safe (queries compile and
    look up concurrently from server handler threads)."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key: str):
        """The cached LoweredQuery, or None (counts the hit/miss)."""
        with self._lock:
            lq = self._entries.get(key)
            if lq is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return lq

    def insert(self, key: str, lq) -> None:
        with self._lock:
            self._entries[key] = lq
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
