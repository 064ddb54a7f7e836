"""Windowed aggregation state (port of ``auron_tpu/stream/state.py``): the
host twin of the incremental aggregate's scatter (`exec/agg_exec.py`
`_ProbeScatter`).

Per micro-batch, rows reduce to per-(window, key) partials with ONE
lexsort + segmented ``ufunc.reduceat`` pass — the sorted-scatter shape
the device aggregation uses — and only the distinct groups of the batch
touch the store. The store itself is host state on purpose: snapshots
must be **byte-identical** across a kill/resume (the exactly-once
argument rests on it), and host scalars serialize
canonically where device buffers would drag capacity padding and
placement into the bytes.

Aggregate semantics match the batch engine: sum/min/max/avg over an
empty-or-all-null group finalize to NULL, count counts valid lanes,
count(*) counts rows.
"""

from __future__ import annotations

import json

import numpy as np

#: state slots per aggregate function: accumulator (+ valid count)
_SLOTS = {"sum": 2, "avg": 2, "min": 2, "max": 2, "count": 1,
          "count_star": 1}


def _group_segments(wins: np.ndarray, keys: list[np.ndarray]):
    """Lexsort rows by (window, key...) and find segment starts.
    Returns (order, starts): ``order`` permutes rows to sorted-group
    order, ``starts[g]`` is the first sorted row of group g."""
    order = np.lexsort(tuple(reversed([np.asarray(k) for k in keys]))
                       + (np.asarray(wins),))
    ws = wins[order]
    changed = ws[1:] != ws[:-1]
    for k in keys:
        ks = np.asarray(k)[order]
        changed = changed | (ks[1:] != ks[:-1])
    starts = np.flatnonzero(np.concatenate(([True], changed)))
    return order, starts


class WindowStore:
    """(window_start, group key) -> aggregate accumulators.

    ``agg_funcs`` is the ordered aggregate list of the streaming plan;
    ``update`` folds one assigned micro-batch, ``emit_closed`` pops and
    finalizes every window the watermark closed, ``snapshot``/``restore``
    round-trip the complete state as canonical bytes.
    """

    def __init__(self, agg_funcs: list[str]):
        for f in agg_funcs:
            if f not in _SLOTS:
                raise ValueError(f"unsupported streaming aggregate {f!r}")
        self.agg_funcs = list(agg_funcs)
        # (win:int, key python scalars...) -> [slot values...]
        self._state: dict[tuple, list] = {}

    def __len__(self) -> int:
        return len(self._state)

    # -- fold ---------------------------------------------------------------

    def update(self, wins: np.ndarray, keys: list[np.ndarray],
               vals: list[tuple[np.ndarray, np.ndarray] | None],
               group_keys: list[np.ndarray] | None = None) -> int:
        """Fold assigned rows: ``wins``/``keys`` aligned per row, ``vals[j]``
        = (values, valid) for agg j (None for count(*)). Returns the
        number of distinct groups touched. ``group_keys`` (optional): per
        key a numeric stand-in equal where the key is equal and nowhere
        else (a string's code in a vocabulary of distinct entries), sorted
        on in its place: the same groups, each folding its rows in the
        same order, so the state is what sorting on ``keys`` gives."""
        if len(wins) == 0:
            return 0
        order, starts = _group_segments(wins, group_keys or keys)
        ws = wins[order]
        ks = [np.asarray(k)[order] for k in keys]
        sizes = np.diff(np.concatenate((starts, [len(order)])))
        partials = []  # per agg: list of slot arrays, one value per group
        for func, v in zip(self.agg_funcs, vals):
            if func == "count_star":
                partials.append([sizes.astype(np.int64)])
                continue
            values, valid = v
            values = np.asarray(values)[order]
            valid = np.asarray(valid, dtype=bool)[order]
            n = np.add.reduceat(valid.astype(np.int64), starts)
            if func == "count":
                partials.append([n])
            elif func in ("sum", "avg"):
                acc = values.astype(np.float64, copy=True) \
                    if values.dtype.kind == "f" \
                    else values.astype(np.int64, copy=True)
                acc[~valid] = 0
                partials.append([np.add.reduceat(acc, starts), n])
            else:  # min / max
                acc = values.copy()
                if acc.dtype.kind == "f":
                    fill = np.inf if func == "min" else -np.inf
                else:
                    info = np.iinfo(acc.dtype)
                    fill = info.max if func == "min" else info.min
                acc[~valid] = fill
                red = np.minimum if func == "min" else np.maximum
                partials.append([red.reduceat(acc, starts), n])
        # Python scalars once an array (``tolist`` gives what ``item`` does)
        gwins = ws[starts].tolist()
        gkeys = [k[starts].tolist() if k.dtype != object else
                 [x.item() if hasattr(x, "item") else x for x in k[starts]] for k in ks]
        partials = [[p.tolist() for p in agg] for agg in partials]
        for g in range(len(starts)):
            gkey = (gwins[g],) + tuple(k[g] for k in gkeys)
            row = self._state.get(gkey)
            if row is None:
                self._state[gkey] = [p[g] for agg in partials for p in agg]
                continue
            i = 0
            for func, agg in zip(self.agg_funcs, partials):
                if func in ("sum", "avg"):
                    row[i] += agg[0][g]
                    row[i + 1] += agg[1][g]
                elif func in ("min", "max"):
                    pick = min if func == "min" else max
                    if agg[1][g]:  # only valid-lane partials participate
                        row[i] = (agg[0][g] if row[i + 1] == 0
                                  else pick(row[i], agg[0][g]))
                    row[i + 1] += agg[1][g]
                else:
                    row[i] += agg[0][g]
                i += _SLOTS[func]
        return len(starts)

    # -- emission -----------------------------------------------------------

    def emit_closed(self, watermark_ms: int, size_ms: int):
        """Pop every window with end <= watermark. Returns
        [(window_start, [(key..., agg values...), ...]), ...] — windows
        ascending, rows within a window sorted by key: the deterministic
        emission order the exactly-once replay relies on."""
        due = sorted(k for k in self._state
                     if k[0] + size_ms <= watermark_ms)
        out: list[tuple[int, list[tuple]]] = []
        for gkey in due:
            row = self._state.pop(gkey)
            finals, i = [], 0
            for func in self.agg_funcs:
                if func in ("count", "count_star"):
                    finals.append(row[i])
                elif func == "avg":
                    finals.append(row[i] / row[i + 1] if row[i + 1] else None)
                else:  # sum / min / max: NULL over all-null groups
                    finals.append(row[i] if row[i + 1] else None)
                i += _SLOTS[func]
            if out and out[-1][0] == gkey[0]:
                out[-1][1].append(tuple(gkey[1:]) + tuple(finals))
            else:
                out.append((gkey[0], [tuple(gkey[1:]) + tuple(finals)]))
        return out

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self) -> bytes:
        """Canonical bytes of the COMPLETE state, sorted by (window,
        key): two identical stores produce identical bytes, which is
        what makes checkpoint equality a real bit-identity proof."""
        rows = [[list(k), v] for k, v in sorted(self._state.items())]
        return json.dumps({"funcs": self.agg_funcs, "rows": rows},
                          separators=(",", ":")).encode()

    def restore(self, data: bytes) -> None:
        doc = json.loads(data)
        if doc["funcs"] != self.agg_funcs:
            raise ValueError(
                f"checkpoint aggregates {doc['funcs']} != plan "
                f"{self.agg_funcs}: the snapshot belongs to another view")
        self._state = {tuple(k): list(v) for k, v in doc["rows"]}
