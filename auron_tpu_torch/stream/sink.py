"""Pluggable stream sinks.

A sink receives one **emission** per closed window — the window bounds
plus its finalized rows in deterministic order — tagged with a
monotonically increasing ``seq``. Exactly-once rests on two duties:

- ``emit(emission)`` appends; it may be called again with the SAME
  payload after a crash-resume (the pipeline truncates first);
- ``truncate(seq)`` discards every emission with ``emission.seq >=
  seq`` — the resume path rewinds the sink to the last checkpoint's
  emit sequence before replaying, so re-emitted windows overwrite
  rather than duplicate.

Add a sink: implement the three methods, ``register_sink("name",
factory)``, reference it as ``name:arg``. Port of
``auron_tpu/stream/sink.py``: an emission's JSON equals the reference's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Protocol


@dataclass(frozen=True)
class Emission:
    """One closed window: rows are (key..., agg...) tuples, key-sorted."""

    seq: int
    window_start: int
    window_end: int
    columns: tuple[str, ...]
    rows: tuple[tuple, ...]

    def to_json(self) -> str:
        return json.dumps(
            {"seq": self.seq, "window_start": self.window_start,
             "window_end": self.window_end, "columns": list(self.columns),
             "rows": [list(r) for r in self.rows]},
            separators=(",", ":"))


class StreamSink(Protocol):
    def emit(self, emission: Emission) -> None: ...

    def truncate(self, seq: int) -> None: ...

    def close(self) -> None: ...


class CollectSink:
    """In-memory sink — tests and `/stream` inspect read it back."""

    def __init__(self):
        self.emissions: list[Emission] = []

    def emit(self, emission: Emission) -> None:
        self.emissions.append(emission)

    def truncate(self, seq: int) -> None:
        self.emissions = [e for e in self.emissions if e.seq < seq]

    def close(self) -> None:
        pass


class JsonlFileSink:
    """One JSON line per emission. ``truncate`` rewrites the file
    keeping lines below the sequence — atomic via the same temp+replace
    protocol checkpoints use, so a kill mid-truncate never leaves a
    half-written sink file."""

    def __init__(self, path: str):
        self.path = path

    def emit(self, emission: Emission) -> None:
        with open(self.path, "a") as f:
            f.write(emission.to_json() + "\n")

    def truncate(self, seq: int) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            keep = [ln for ln in f
                    if ln.strip() and json.loads(ln)["seq"] < seq]
        tmp = self.path + ".truncate"
        try:
            with open(tmp, "w") as f:
                f.writelines(keep)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def close(self) -> None:
        pass


_SINKS: dict[str, Callable[[str], StreamSink]] = {
    "collect": lambda arg: CollectSink(),
    "jsonl": JsonlFileSink,
}


def register_sink(name: str, factory: Callable[[str], StreamSink]) -> None:
    _SINKS[name] = factory


def make_sink(spec: str) -> StreamSink:
    """``collect`` or ``jsonl:/path/out.jsonl`` (registry-extensible)."""
    name, _, arg = spec.partition(":")
    if name not in _SINKS:
        raise ValueError(
            f"unknown sink {name!r} (have: {sorted(_SINKS)})")
    return _SINKS[name](arg)
