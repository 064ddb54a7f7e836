"""Whole-stage fusion: pipeline segments as captured CUDA graphs.

Port of ``auron_tpu/plan/fusion.py``. A **segment finder** walks the exec
tree and finds each maximal filter->project(->partial-agg-input) chain
between blocking boundaries (sorts, aggregate state, join builds, shuffles,
unions, limits: every operator that is not a stateless row stage); a
**stage program** is the chain's per-batch work as one plain function over
tensors; a **cost model** decides fuse or not per segment (``_should_fuse``:
on CUDA every capture-safe segment fuses, on the CPU only segments whose
eager dispatch count reaches ``exec.fuse.min.ops``, so the CPU fuses
exactly the segments the JAX package fuses on its CPU backend).

On CUDA a stage program is captured once per (segment signature,
extension, capacity bucket, input shapes) into a ``torch.cuda.CUDAGraph``
(``_GraphCache``) and replayed for every later batch of that key; on the
CPU the same function runs eagerly. Results are bit-identical with the
pass off (``exec.fuse.enable=off``).

- **Segments.** A ``GenerateExec`` is not a row stage, so it ends a
  segment: its per-batch total is a host read and its output chunks are
  made on the host's schedule, which a replayed graph cannot repeat. A
  stage may read its chunks (a partial aggregate's input projection).
- **Capture safety** (``expr_capture_safe``): the reference's
  ``expr_trace_safe`` rule over the port's evaluator, whose non-dictionary
  paths are device-only tensor ops (no ``.item()``, no ``nonzero``, no
  boolean-mask indexing, no copy from host memory: a literal is a fill
  kernel). Dictionary columns pass through only as bare references; the
  host vocabulary re-attaches on emission.
- **Buffers.** A graph reads static input tensors and writes its own
  outputs. A replay copies the batch columns the program reads into the
  inputs, and its outputs are cloned after the replay, so no batch held
  downstream (transfer windows, staged aggregate parts, pending join
  harvests) ever aliases a graph buffer. Outputs of at most
  ``transfer.PACK_BYTES`` together are written into one buffer at the end
  of the program, so one clone serves them all (as views of it). Side
  inputs (a join's build tensors, a dense table's anchor geometry) are
  copied only when they change; the graph holds its sources weakly, so it
  keeps no build alive.
- **Memory.** Each graph captures into a private pool. The cache is
  bounded (a quarter of the memory manager's budget, least recently
  replayed out) and is one spillable consumer of the memory manager,
  whose spill drops its graphs; a graph's bytes (its pool's segments and static inputs) are
  counted once, and the resident total goes into ``fusion_stats``.
- **No fallback that hides the device.** A capture or replay that fails
  raises ``StageCaptureError`` naming the step; only a segment the
  plan-time rule refuses runs eagerly, counted by reason.
- **Launches.** A kernel launched inside a captured program (K1 in a
  shuffle stage) is counted once per replay: the capture records each
  kernel counter's delta (the capture itself launches nothing, so the
  delta is taken back) and every replay adds it.
- **Metric attribution.** A stage's wall is split back into per-operator
  children (FilterExec, ProjectExec, HashAggExec, the join, the writer) by
  the cost model's weights; the remainder stays on the stage node.
"""

from __future__ import annotations

import copy
import threading
import time
import weakref
from collections import OrderedDict
from typing import Iterator

import torch

from auron_tpu_torch import obs
from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, DeviceBatch, compaction_bucket
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.ops import launch_count
from auron_tpu_torch.runtime.transfer import PACK_BYTES, flat_bytes
from auron_tpu_torch.utils.config import (
    FUSE_AGG_INPUTS, FUSE_ENABLE, FUSE_MIN_OPS, FUSE_PROBE, FUSE_SHUFFLE, Configuration,
    resolve_tri,
)

# ---------------------------------------------------------------------------
# capture safety
# ---------------------------------------------------------------------------

#: expression nodes whose evaluation is a pure tensor program over
#: dictionary-free operands (reference ``fusion.py:80``). ``ScalarFunc`` is
#: not one: its dictionary kernels and host paths read vocabularies and
#: rows on the host, and LIST values are nested (dictionary) values
_FUSABLE_NODES = (
    ir.Literal, ir.Cast, ir.BinaryOp, ir.Not, ir.IsNull, ir.IsNotNull,
    ir.If, ir.Case, ir.Coalesce, ir.In,
)

_NESTED_KINDS = (T.TypeKind.LIST, T.TypeKind.MAP, T.TypeKind.STRUCT)


def expr_capture_safe(e: ir.Expr, schema: T.Schema, allow_dict_out: bool = False) -> bool:
    """True when evaluating ``e`` in a stage program over a dictionary-less
    batch is exactly the eager evaluation and captures into a CUDA graph.
    The reference's ``expr_trace_safe`` (``fusion.py:88-107``), and no
    stricter: every expression it admits evaluates in the port
    (``exprs/eval.py``) through device-only ops on non-dictionary operands
    (literals are fill kernels, decimal64 arithmetic and casts int64 ops
    with Python-int constants, integer division takes
    ``decimal_math._safe_divisor``), and the dictionary transforms that
    would read host vocabularies it refuses already (ROADMAP Queue 3).
    ``allow_dict_out`` admits a BARE dictionary column (projection
    passthrough); IsNull and IsNotNull of a bare column read only its
    validity."""
    if isinstance(e, ir.Column):
        dt = e.dtype_of(schema)
        return allow_dict_out or not (dt.is_dict_encoded or dt.kind in _NESTED_KINDS)
    if isinstance(e, (ir.IsNull, ir.IsNotNull)) and isinstance(e.child, ir.Column):
        return True
    if not isinstance(e, _FUSABLE_NODES):
        return False
    dt = e.dtype_of(schema)
    if dt.is_dict_encoded or dt.kind in _NESTED_KINDS:
        return False
    return all(expr_capture_safe(c, schema) for c in e.children())


def _expr_nodes(e: ir.Expr) -> int:
    return 1 + sum(_expr_nodes(c) for c in e.children())


def _columns(e: ir.Expr) -> list[int]:
    return [c.index for c in ir.walk(e) if isinstance(c, ir.Column)]


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

_FUSE_LOCK = threading.Lock()
_SEEN_PROGRAMS: set = set()
_SEEN_BUCKETS: set = set()
_STATS_ZERO = {"segments": 0, "probe_segments": 0, "writer_segments": 0,
               "dense_segments": 0, "programs": 0, "buckets": 0, "captures": 0,
               "replays": 0, "eager_runs": 0, "evictions": 0, "pool_bytes": 0}
_STATS: dict = dict(_STATS_ZERO)
#: segments left eager at plan time, by reason
_EAGER: dict = {}


def fusion_stats() -> dict:
    """``segments`` FusedStageExec built (``probe_segments`` /
    ``writer_segments`` / ``dense_segments`` those carrying a join-probe,
    shuffle or dense-aggregate extension), ``programs`` distinct programs
    dispatched, ``buckets`` distinct capacity buckets, ``captures`` CUDA
    graphs captured (one per program key; CPU runs count ``eager_runs``),
    ``replays``, ``evictions`` graphs dropped (cap or spill), ``pool_bytes``
    the bytes of the graphs cached now, and ``eager`` the segments left
    eager at plan time by reason."""
    with _FUSE_LOCK:
        out = dict(_STATS)
        out["eager"] = dict(_EAGER)
    return out


def reset_fusion_stats() -> None:
    """Zero the counters (captured graphs stay cached: a key captured
    before is not captured again)."""
    with _FUSE_LOCK:
        _SEEN_PROGRAMS.clear()
        _SEEN_BUCKETS.clear()
        _STATS.update(_STATS_ZERO)
        _EAGER.clear()
        _STATS["pool_bytes"] = _GRAPHS.pool_bytes()


def _count(key: str, n: int = 1) -> None:
    with _FUSE_LOCK:
        _STATS[key] += n


def _note_eager(reason: str) -> None:
    with _FUSE_LOCK:
        _EAGER[reason] = _EAGER.get(reason, 0) + 1


# ---------------------------------------------------------------------------
# the graph cache
# ---------------------------------------------------------------------------


class StageCaptureError(RuntimeError):
    """A capture-safe stage program failed to capture or replay."""


def _kernel_counters() -> list[dict]:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    return [partition_kernels.LAUNCHES, bitonic.LAUNCHES]


def _kernel_locks() -> list:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    return [partition_kernels._launch_lock, bitonic._launch_lock]


class _Graph:
    __slots__ = ("graph", "static_in", "static_side", "side_src", "static_out", "out_plan",
                 "tally", "label", "nbytes", "done")

    def replay(self, batch_in: tuple, side_in: tuple) -> tuple:
        stream = torch.cuda.current_stream(batch_in[0].device)
        if self.done is not None:
            # the last replay may have run on another task's stream: its
            # output copies must finish before this one overwrites the
            # static inputs
            stream.wait_event(self.done)
        for s, t in zip(self.static_in, batch_in):
            s.copy_(t)
        # side sources are held weakly: a graph never keeps a finished
        # join's build alive; a new or collected source is copied in
        if len(side_in) != len(self.side_src) or any(
                r() is not t for r, t in zip(self.side_src, side_in)):
            for s, t in zip(self.static_side, side_in):
                s.copy_(t)
            self.side_src = tuple(weakref.ref(t) for t in side_in)
        try:
            self.graph.replay()
        except Exception as e:  # noqa: BLE001 — re-raised, naming the step
            raise StageCaptureError(f"replay of fused stage {self.label} failed: {e}") from e
        for counts, lock, tally in zip(_kernel_counters(), _kernel_locks(), self.tally):
            for k, n in tally.items():
                launch_count.add(counts, lock, k, n)
        if self.out_plan is None:
            out = tuple(o.clone() for o in self.static_out)
        else:
            out = _unpack(self.static_out[0].clone(), self.out_plan)
        if self.done is None:
            self.done = torch.cuda.Event()
        self.done.record(stream)  # re-recorded: a wait takes its latest record
        return out


def _pack_plan(outs: tuple):
    """How a graph's outputs lie in one byte buffer: (the outputs' order in
    it, and per run of outputs of one dtype and shape (start byte, end
    byte, dtype, shape, their indices)), the widest elements first so every
    view stays aligned; or None where they are one tensor, pass
    ``PACK_BYTES`` or are not all contiguous."""
    if len(outs) < 2 or not all(isinstance(o, torch.Tensor) and o.is_contiguous()
                                for o in outs):
        return None
    if sum(o.numel() * o.element_size() for o in outs) > PACK_BYTES:
        return None
    order = sorted(range(len(outs)), key=lambda i: (-outs[i].element_size(),
                                                     str(outs[i].dtype), tuple(outs[i].shape)))
    runs, pos = [], 0
    for i in order:
        o = outs[i]
        nbytes = o.numel() * o.element_size()
        if runs and runs[-1][2] == o.dtype and runs[-1][3] == o.shape:
            runs[-1][1] += nbytes
            runs[-1][4].append(i)
        else:
            runs.append([pos, pos + nbytes, o.dtype, o.shape, [i]])
        pos += nbytes
    return tuple(order), tuple((a, b, dt, sh, tuple(ix)) for a, b, dt, sh, ix in runs)


def _unpack(buf: torch.Tensor, plan) -> tuple:
    """The outputs a packed buffer holds, as views of it (a run of outputs
    of one dtype and shape comes out of one view)."""
    out = [None] * len(plan[0])
    for a, b, dtype, shape, ix in plan[1]:
        v = buf[a:b].view(dtype)
        if len(ix) == 1:
            out[ix[0]] = v.view(shape)
        else:
            for i, t in zip(ix, v.view((len(ix), *shape)).unbind(0)):
                out[i] = t
    return tuple(out)


def _pool_segment_bytes(pool) -> int:
    """Device bytes of the allocator segments that belong to one private
    graph pool."""
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


class _GraphCache:
    """Captured stage programs by key, least recently replayed first out.

    Each graph captures into a private memory pool, so dropping it makes
    its memory free again. A graph's bytes are its pool's segments and its
    static input copies, each counted once. The cache is one spillable
    consumer of the memory manager: past a quarter of the manager's
    budget it drops its least recently used graphs, and a spill drops them
    all (a later batch of a dropped key captures again)."""

    name = "fusion-graph-cache"

    def __init__(self):
        self._graphs: OrderedDict = OrderedDict()
        self._bytes = 0
        self._managers = weakref.WeakSet()
        self.evictions = 0  # over the process (fusion_stats' count resets)

    def pool_bytes(self) -> int:
        return self._bytes

    def mem_used(self) -> int:
        return self._bytes

    def spill(self) -> int:
        with _GRAPH_LOCK:
            freed = self._bytes
            self._evict(len(self._graphs))
        return freed

    def _evict(self, n: int) -> None:
        for _ in range(n):
            _, g = self._graphs.popitem(last=False)
            if g.done is not None:
                # its last replay may still run on another task's stream:
                # its pool stays allocated until that replay is done
                g.done.synchronize()
            self._bytes -= g.nbytes
        self.evictions += n
        with _FUSE_LOCK:
            _STATS["evictions"] += n
            _STATS["pool_bytes"] = self._bytes

    def _register(self):
        """Join the current memory manager once (tests and budgeted runs
        replace it for a while); returns it."""
        from auron_tpu_torch.memory.memmgr import MemManager

        mm = MemManager.get()
        if mm not in self._managers:
            mm.register(self, spillable=True)
            self._managers.add(mm)
        return mm

    def run(self, key, label: str, fn, batch_in: tuple, side_in: tuple, node) -> tuple:
        if batch_in[0].device.type != "cuda":
            _count("eager_runs")
            return fn(batch_in, side_in)
        with _GRAPH_LOCK:
            mm = self._register()
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                _count("replays")
                node.add("stage_replays", 1)
                return g.replay(batch_in, side_in)
            # the first batch of a key runs eagerly: it is that batch's
            # answer and the warm-up (lazy module loads) the capture needs
            out = fn(batch_in, side_in)
            g = self._capture(label, fn, batch_in, side_in)
            node.add("stage_captures", 1)
            self._admit(key, g, mm.budget // GRAPH_BUDGET_SHARE)
            return out

    def _admit(self, key, g: _Graph, cap: int) -> None:
        """Cache ``g`` under ``key``, then drop the least recently used
        graphs until the cache fits ``cap`` (the newest always stays)."""
        self._graphs[key] = g
        self._bytes += g.nbytes
        n, left = 0, self._bytes
        for old in self._graphs.values():
            if left <= cap or n == len(self._graphs) - 1:
                break
            left -= old.nbytes
            n += 1
        self._evict(n)

    def _capture(self, label: str, fn, batch_in: tuple, side_in: tuple) -> _Graph:
        """Capture ``fn`` into a new graph: one ``compiles`` of the engine
        counters and one ``compile`` event of the span timeline."""
        from auron_tpu_torch.utils.profiling import note_compile

        t0 = time.perf_counter()
        g = _Graph()
        g.label = label
        dev = batch_in[0].device
        g.static_in = tuple(t.clone() for t in batch_in)
        g.static_side = tuple(t.clone() for t in side_in)
        g.side_src = tuple(weakref.ref(t) for t in side_in)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        g.graph = torch.cuda.CUDAGraph()
        # the capture records launches without running them: this thread's
        # counts go to the graph's tally (a replay adds it), other task
        # threads' launches keep counting
        with launch_count.diverted() as tally:
            try:
                with torch.cuda.graph(g.graph, pool=pool, capture_error_mode="thread_local"):
                    outs = tuple(fn(g.static_in, g.static_side))
                    # small outputs land in one buffer, so a replay clones
                    # it once and hands out views
                    g.out_plan = _pack_plan(outs)
                    g.static_out = outs if g.out_plan is None else (
                        torch.cat([flat_bytes(outs[i]) for i in g.out_plan[0]]),)
            except Exception as e:  # noqa: BLE001 — re-raised, naming the step
                raise StageCaptureError(f"capture of fused stage {label} failed: {e}") from e
        g.tally = [tally.get(id(c), {}) for c in _kernel_counters()]
        g.done = None
        static = sum(t.numel() * t.element_size() for t in g.static_in + g.static_side)
        g.nbytes = _pool_segment_bytes(pool) + static
        _count("captures")
        note_compile(time.perf_counter() - t0, "graph_capture")
        return g


class _TimedLock:
    """The graph cache's re-entrant lock; an acquire that finds it held by
    another thread notes its wait (``utils/profiling.note_lock_wait``)."""

    def __init__(self):
        self._lock = threading.RLock()

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            from auron_tpu_torch.utils.profiling import note_lock_wait

            t0 = time.perf_counter()
            self._lock.acquire()
            note_lock_wait("graph", time.perf_counter() - t0)
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()


_GRAPH_LOCK = _TimedLock()
_GRAPHS = _GraphCache()
#: the graph cache keeps at most 1/GRAPH_BUDGET_SHARE of the memory budget
GRAPH_BUDGET_SHARE = 4


# ---------------------------------------------------------------------------
# links and payloads (reference ``fusion.py:343-480``)
# ---------------------------------------------------------------------------


class _Link:
    """Anchor hand-off from a consumer to the stage feeding it. Stage and
    consumer share one thread (the stage generator resumes inside the
    consumer's pull); the lock guards foreign observers only."""

    def __init__(self):
        self._lock = threading.Lock()
        self._anchor: dict | None = None

    def publish(self, **anchor) -> None:
        with self._lock:
            self._anchor = anchor

    def clear(self) -> None:
        with self._lock:
            self._anchor = None

    def snapshot(self) -> dict | None:
        with self._lock:
            return self._anchor


class ProbePrepLink(_Link):
    """A hash join publishes its prepared build here (``driver.
    publish_probe_prep``); the stage then runs the probe prologue in its
    program and attaches a ``ProbePrepPayload`` to each batch."""


class DensePrepLink(_Link):
    """A dense partial aggregate publishes its anchor (epoch and geometry
    tensor) here; the stage computes the fold's guard, slot index and
    masked planes in its program."""


class ProbePrepPayload:
    """One probe batch's stage-computed prologue (``Batch._probe_prep``):
    ``take`` names the eager step it replaced: "probe" (lookup only),
    "gather" (build columns gathered at probe width), "compact" (the
    predicted compact-take at ``out_cap``) or "exists" (existence flags).
    ``build`` is the build it was computed under: the driver refuses a
    payload of any other build."""

    __slots__ = ("build", "kind", "take", "pred_cap", "out_cap", "bi", "ok", "bcols",
                 "taken", "probe_matched")

    def __init__(self, build, kind, take, pred_cap=None, out_cap=None, bi=None, ok=None,
                 bcols=None, taken=None, probe_matched=None):
        self.build, self.kind, self.take = build, kind, take
        self.pred_cap, self.out_cap = pred_cap, out_cap
        self.bi, self.ok, self.bcols, self.taken = bi, ok, bcols, taken
        self.probe_matched = probe_matched


class ShufflePrepPayload:
    """One batch's stage-computed repartition (``Batch._shuffle_prep``): the
    pid-clustered row order and per-partition counts."""

    __slots__ = ("n_out", "order", "counts")

    def __init__(self, n_out, order, counts):
        self.n_out, self.order, self.counts = n_out, order, counts


class DensePrepPayload:
    """One batch's dense-fold prep (``Batch._dense_prep``), computed under
    the anchor of ``epoch``: the all-in-range flag, the slot index and the
    masked planes."""

    __slots__ = ("epoch", "flag", "idx", "present", "planes")

    def __init__(self, epoch, flag, idx, present, planes):
        self.epoch, self.flag, self.idx, self.present, self.planes = \
            epoch, flag, idx, present, planes


# ---------------------------------------------------------------------------
# the stage program
# ---------------------------------------------------------------------------


def _run_steps(sel, values, validity, steps: tuple):
    """The segment's steps in order: ("filter", schema, predicates) refine
    ``sel``; ("project", schema, exprs) replace the column planes. Each step
    carries its operator's input schema, so typing is the eager path's. The
    common-subexpression memo spans consecutive steps over one layout and
    resets at each projection. Returns (sel, ColumnVals of the last
    projection or None)."""
    outs = None
    memo: dict = {}
    for kind, schema, exprs in steps:
        b = Batch(schema, DeviceBatch(sel, values, validity), (None,) * len(schema.fields))
        ev = Evaluator(schema)
        if kind == "filter":
            for p in exprs:
                cv = ev._eval(p, b, memo)
                sel = sel & cv.validity & cv.values.to(torch.bool)
        else:
            outs = [ev._eval(e, b, memo) for e in exprs]
            values = tuple(cv.values for cv in outs)
            validity = tuple(cv.validity for cv in outs)
            memo = {}
    return sel, outs


def _view(schema: T.Schema, sel, cols) -> Batch:
    """A dictionary-less batch over (values, validity) pairs."""
    return Batch(schema, DeviceBatch(sel, tuple(v for v, _ in cols), tuple(m for _, m in cols)),
                 (None,) * len(schema.fields))


def _batch_in(dev: DeviceBatch, reads: tuple) -> tuple:
    """A program's batch inputs: sel, then the read columns' values and
    validity planes."""
    return (dev.sel, *(dev.values[c] for c in reads), *(dev.validity[c] for c in reads))


def _planes_of(batch_in: tuple, reads: tuple, n_cols: int):
    """(sel, values, validity) of ``n_cols`` columns from a program's batch
    inputs; a column the program does not read is None."""
    vals, masks = [None] * n_cols, [None] * n_cols
    for j, c in enumerate(reads):
        vals[c] = batch_in[1 + j]
        masks[c] = batch_in[1 + len(reads) + j]
    return batch_in[0], tuple(vals), tuple(masks)


class _Sig:
    """A stage program's signature with its hash taken once: it holds
    schemas and expression trees, whose hash a tuple recomputes on every
    lookup, and a batch looks its program up three times."""

    __slots__ = ("sig", "_hash")

    def __init__(self, sig: tuple):
        self.sig = sig
        self._hash = hash(sig)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return self is other or (isinstance(other, _Sig) and self._hash == other._hash
                                 and self.sig == other.sig)


def _key(sig, cap: int, inputs: tuple):
    """A graph's cache key: the program, the capacity bucket and the
    inputs' dtypes, shapes and device."""
    return (sig, cap, tuple((t.dtype, tuple(t.shape)) for t in inputs), str(inputs[0].device))


def filter_sel(b: Batch, schema: T.Schema, preds: tuple, reads: tuple, node) -> torch.Tensor:
    """A standalone FilterExec's predicate chain as one program per
    (schema, predicates, capacity bucket) (``exec.filter.fuse``): the
    refined selection."""
    steps = (("filter", schema, preds),)

    def fn(batch_in, side_in):
        return (_run_steps(*_planes_of(batch_in, reads, len(schema)), steps)[0],)

    batch_in = _batch_in(b.device, reads)
    return _GRAPHS.run(_key(("filter", steps, reads), b.capacity, batch_in),
                       f"FilterExec cap={b.capacity}", fn, batch_in, (), node)[0]


# ---------------------------------------------------------------------------
# the fused operator
# ---------------------------------------------------------------------------


class FusedStageExec(ExecOperator):
    """One pipeline segment as one program per batch. Built only by
    ``fuse_exec_tree``:

    - ``steps``: the program's static description;
    - ``out_stamp``: the emitted schema (None: the input's rides through);
    - ``src``: per output column its input column when it is a bare
      reference chain (passthrough: the input's tensors and dictionary are
      emitted as they are), else None (computed in the program);
    - ``reads``: the input columns the program reads (its graph inputs);
    - ``op_shares``: (operator name, cost weight) per constituent operator.
    """

    def __init__(self, child: ExecOperator, steps: tuple, out_stamp, src, reads: tuple,
                 op_shares: tuple, schema: T.Schema):
        super().__init__([child], schema)
        self.steps = steps
        self.out_stamp = out_stamp
        self.src = src
        self.reads = reads
        self.op_shares = op_shares
        self.has_project = any(s[0] == "project" for s in steps)
        #: no filter and every output a passthrough: the plain program would
        #: be empty, so such a stage only re-wraps (an extension still runs)
        self._noop = (not any(s[0] == "filter" for s in steps)
                      and all(c is not None for c in (src or ())))
        self.dense_link: DensePrepLink | None = None
        self._dense_spec: tuple = ()
        self.probe_link: ProbePrepLink | None = None
        self._probe_cfg: tuple = ()
        self.shuffle: tuple | None = None
        #: (extension, its config, reads) -> the program's signature
        self._sigs: dict = {}
        _count("segments")

    # -- extensions

    def _read_out_cols(self, cols) -> None:
        """Add output columns an extension reads to the program's inputs."""
        extra = set(self.reads)
        for c in cols:
            s = c if self.src is None else self.src[c]
            if s is not None:
                extra.add(s)
        self.reads = tuple(sorted(extra))

    def attach_dense_link(self, link: DensePrepLink, n_keys: int, spec: tuple) -> None:
        self.dense_link = link
        self._dense_spec = (n_keys, spec)
        self._read_out_cols(range(len(self.out_stamp or self.children[0].schema)))
        extra = n_keys * 4 + len(spec) * 2
        self.op_shares = tuple((nm, w + extra if nm == "HashAggExec" else w)
                               for nm, w in self.op_shares)
        _count("dense_segments")

    def attach_probe_link(self, link: ProbePrepLink, key_exprs: tuple, probe_outer: bool,
                          pcol_ids: tuple, bcol_ids: tuple, op_name: str, cost: int) -> None:
        """The probe work's cost share is charged to the join's name."""
        self.probe_link = link
        self._probe_cfg = (key_exprs, probe_outer, pcol_ids, bcol_ids)
        self._read_out_cols({c for k in key_exprs for c in _columns(k)} | set(pcol_ids))
        self.op_shares = tuple(self.op_shares) + ((op_name, cost),)
        _count("probe_segments")

    def attach_shuffle(self, spec: tuple, n_out: int, cost: int) -> None:
        self.shuffle = (spec, n_out)
        if spec[0] == "hash":
            self._read_out_cols({c for e in spec[1] for c in _columns(e)})
        self.op_shares = tuple(self.op_shares) + (("ShuffleWriterExec", cost),)
        _count("writer_segments")

    def fused_op_names(self) -> list[str]:
        return [nm for nm, _ in self.op_shares]

    # -- the program

    def _out_schema(self) -> T.Schema:
        return self.out_stamp or self.children[0].schema

    def _program(self, ext):
        """fn(batch_in, side_in) -> flat output tensors: the steps, the
        computed output columns and the extension ``ext(sel, out_col,
        side_in)``'s outputs. ``out_col(j)`` is output column j as a
        ColumnVal (computed, or the passthrough input)."""
        reads, n_in = self.reads, len(self.children[0].schema)
        steps, src = self.steps, self.src
        out_schema = self._out_schema()

        def fn(batch_in, side_in):
            sel, vals, masks = _planes_of(batch_in, reads, n_in)
            sel, outs = _run_steps(sel, vals, masks, steps)
            computed = [] if outs is None else [
                (cv.values, cv.validity) for j, cv in enumerate(outs) if src[j] is None]

            def out_col(j: int) -> ColumnVal:
                dt = out_schema[j].dtype
                if src is None:
                    return ColumnVal(vals[j], masks[j], dt)
                if src[j] is not None:
                    return ColumnVal(vals[src[j]], masks[src[j]], dt)
                cv = outs[j]
                return ColumnVal(cv.values, cv.validity, dt)

            extra = ext(sel, out_col, side_in) if ext is not None else ()
            return (sel, *(v for v, _ in computed), *(m for _, m in computed), *extra)

        return fn

    def _dispatch(self, b: Batch, ext_name: str, ext_cfg, ext, side_in: tuple, node):
        """Run the program on one batch: (sel, values, validity of the
        emitted batch, extension outputs)."""
        dev = b.device
        batch_in = _batch_in(dev, self.reads)
        sig = self._sigs.get((ext_name, ext_cfg, self.reads))
        if sig is None:
            sig = self._sigs[(ext_name, ext_cfg, self.reads)] = _Sig(
                (self.steps, self.src, self.reads, ext_name, ext_cfg))
        key = _key(sig, b.capacity, batch_in + side_in)
        with _FUSE_LOCK:
            if sig not in _SEEN_PROGRAMS:
                _SEEN_PROGRAMS.add(sig)
                _STATS["programs"] += 1
            _SEEN_BUCKETS.add(b.capacity)
            _STATS["buckets"] = len(_SEEN_BUCKETS)
        label = f"{'/'.join(self.fused_op_names())}[{ext_name}] cap={b.capacity}"
        out = _GRAPHS.run(key, label, self._program(ext), batch_in, side_in, node)
        sel = out[0]
        if not self.has_project:
            values, validity = dev.values, dev.validity
            rest = out[1:]
        else:
            n_comp = sum(1 for s in self.src if s is None)
            comp_v, comp_m = out[1:1 + n_comp], out[1 + n_comp:1 + 2 * n_comp]
            rest = out[1 + 2 * n_comp:]
            values, validity, k = [], [], 0
            for s in self.src:
                if s is None:
                    values.append(comp_v[k])
                    validity.append(comp_m[k])
                    k += 1
                else:
                    values.append(dev.values[s])
                    validity.append(dev.validity[s])
        return sel, tuple(values), tuple(validity), rest

    def _emit(self, b: Batch, sel, values, validity) -> Batch:
        if self.has_project:
            dicts = tuple(b.dicts[s] if s is not None else None for s in self.src)
        else:
            dicts = b.dicts
        return Batch(self._out_schema(), DeviceBatch(sel, values, validity), dicts)

    # -- extensions' per-batch work

    def _dense_ext(self, anchor: dict):
        from auron_tpu_torch.exec.agg_exec import dense_fold_planes

        n_keys, spec = self._dense_spec

        def ext(sel, out_col, side_in):
            (geom,) = side_in
            keys = [out_col(i) for i in range(n_keys)]
            ev = Evaluator(T.Schema())
            per_agg, col = [], n_keys
            for s in spec:
                if s[0] == "count_star":
                    per_agg.append([])
                    continue
                cv = out_col(col)
                if s[0] in ("sum", "avg"):
                    cv = ev._cast(cv, s[2])
                per_agg.append([cv])
                col += 1
            flag, idx, present, planes = dense_fold_planes(
                tuple(s[0] for s in spec), True, keys, per_agg, sel, geom, n_keys, guard=True)
            return (flag, idx, present, *planes)

        def attach(rest):
            return "_dense_prep", DensePrepPayload(anchor["epoch"], rest[0], rest[1], rest[2],
                                                   tuple(rest[3:]))

        return ext, (anchor["geom"],), ("dense", self._dense_spec), attach

    def _probe_ext(self, b: Batch, anchor: dict):
        """The probe prologue (driver ``probe_batch`` for a unique or
        existence-LUT build, ``_take_at``): key words, lookup, and the
        build-column gather or predicted compact-take. Returns (ext, side
        inputs, cfg, payload maker)."""
        from types import SimpleNamespace

        from auron_tpu_torch.exec.joins import core

        key_exprs, probe_outer, pcol_ids, bcol_ids = self._probe_cfg
        build, kind = anchor["build"], anchor["kind"]
        bb = build.batch
        pred_cap = out_cap = None
        if kind == "exists":
            take = "exists"
            side = (build.exists_lut,)
        else:
            if not anchor["compact"]:
                take = "gather"
            else:
                pipe = anchor["pipe"]
                pred_cap = pipe.pred.predict(b.capacity) if pipe.pred is not None else None
                if pred_cap is None:
                    take = "probe"  # the seed: the driver's blocking read finishes it
                else:
                    out_cap = compaction_bucket(pred_cap, b.capacity)
                    take = "gather" if out_cap is None else "compact"
            side = ((build.lut,) if build.lut is not None else tuple(build.words))
            if take != "probe":
                side = side + tuple(bb.col_values(c) for c in bcol_ids) + \
                    tuple(bb.col_validity(c) for c in bcol_ids)
        # the key holds the build's ints the program reads as constants: the
        # LUT base (a LUT or existence lookup) or the live count (a search),
        # the build capacity (a row clamp) and the packing
        if kind == "exists":
            consts = (build.lut_base,)
        elif build.lut is not None:
            consts = (build.lut_base, bb.capacity)
        else:
            consts = (build.n_live, bb.capacity)
        cfg = (take, out_cap, build.lut is not None, build.pack, len(build.words),
               probe_outer) + consts
        key_schema = self._out_schema()
        n_b = len(bcol_ids)
        needed = {c for k in key_exprs for c in _columns(k)}

        def ext(sel, out_col, side_in):
            kb = _view(key_schema, sel, [(out_col(j).values, out_col(j).validity)
                                         if j in needed else (None, None)
                                         for j in range(len(key_schema))])
            pvals = Evaluator(key_schema).evaluate(kb, list(key_exprs))
            if take == "exists":
                view = SimpleNamespace(pack=build.pack)
                pwords, pvalid = core.probe_words(view, pvals)
                size = side_in[0].shape[0]
                idx = pwords[0] - build.lut_base
                in_range = (idx >= 0) & (idx < size)
                return (sel & pvalid & in_range & side_in[0][idx.clamp(0, size - 1)],)
            if build.lut is not None:
                lut, words, rest = side_in[0], list(build.words), side_in[1:]
            else:
                lut, words = None, list(side_in[:len(build.words)])
                rest = side_in[len(build.words):]
            view = SimpleNamespace(lut=lut, lut_base=build.lut_base, words=words,
                                   n_live=build.n_live, pack=build.pack,
                                   batch=SimpleNamespace(capacity=bb.capacity))
            pwords, pvalid = core.probe_words(view, pvals)
            bi, ok = core.probe_unique(view, pwords, sel & pvalid)
            if take == "probe":
                return (bi, ok)
            bv, bm = rest[:n_b], rest[n_b:]
            sel_out = sel if probe_outer else ok
            if take == "gather":
                return (bi, ok, *(v[bi] for v in bv), *(m[bi] for m in bm))
            pcols = [(out_col(c).values, out_col(c).validity) for c in pcol_ids]
            pc, bc, new_sel = core.predicted_take(pcols, bi, ok, list(zip(bv, bm)), sel_out,
                                                  out_cap)
            return (bi, ok, new_sel, *(v for v, _ in pc), *(m for _, m in pc),
                    *(v for v, _ in bc), *(m for _, m in bc))

        def attach(rest):
            return "_probe_prep", payload(rest)

        def payload(rest):
            if take == "exists":
                return ProbePrepPayload(build, kind, take, probe_matched=rest[0])
            bi, ok = rest[0], rest[1]
            if take == "probe":
                return ProbePrepPayload(build, kind, take, bi=bi, ok=ok)
            if take == "gather":
                bcols = dict(zip(bcol_ids, zip(rest[2:2 + n_b], rest[2 + n_b:2 + 2 * n_b])))
                return ProbePrepPayload(build, kind, take, pred_cap=pred_cap, bi=bi, ok=ok,
                                        bcols=bcols)
            n_p = len(pcol_ids)
            new_sel, r = rest[2], rest[3:]
            pc = list(zip(r[:n_p], r[n_p:2 * n_p]))
            bc = list(zip(r[2 * n_p:2 * n_p + n_b], r[2 * n_p + n_b:]))
            return ProbePrepPayload(build, kind, take, pred_cap=pred_cap, out_cap=out_cap,
                                    bi=bi, ok=ok, taken=(pc, bc, new_sel))

        return ext, side, ("probe", key_exprs, pcol_ids, bcol_ids) + cfg, attach

    def _shuffle_ext(self, b: Batch, ctx: ExecutionContext):
        from auron_tpu_torch.exec.shuffle.partitioning import partition_ids_of
        from auron_tpu_torch.exec.shuffle.writer import cluster_rows

        spec, n_out = self.shuffle
        # a round-robin start rides as a device scalar (a fill, no host
        # copy), so one program serves every task partition
        side = (torch.full((), ctx.partition_id % n_out, dtype=torch.int64,
                           device=b.torch_device),) if spec[0] == "roundrobin" else ()
        schema = self._out_schema()
        needed = {c for e in spec[1] for c in _columns(e)} if spec[0] == "hash" else set()

        def ext(sel, out_col, side_in):
            kb = _view(schema, sel, [(out_col(j).values, out_col(j).validity)
                                     if j in needed else (None, None)
                                     for j in range(len(schema))])
            pids = partition_ids_of(spec, kb, n_out, side_in[0] if side_in else None)
            order, counts = cluster_rows(sel, pids, n_out)
            return (order, counts)

        def attach(rest):
            return "_shuffle_prep", ShufflePrepPayload(n_out, rest[0], rest[1])

        return ext, side, ("shuffle", spec, n_out), attach

    # -- execute

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        node = ctx.metrics
        shares = []
        for k, (nm, w) in enumerate((nm, w) for nm, w in self.op_shares if w > 0):
            c = node.child(1 + k)  # child 0 is the input operator's node
            c.name = nm
            shares.append((c, w))
        for b in self.child_stream(0, partition, ctx):
            t_all = time.perf_counter_ns()
            dense = self.dense_link.snapshot() if self.dense_link is not None else None
            probe = self.probe_link.snapshot() if self.probe_link is not None else None
            if dense is not None:
                kind, (ext, side, cfg, attach) = "dense", self._dense_ext(dense)
            elif probe is not None:
                kind, (ext, side, cfg, attach) = "probe", self._probe_ext(b, probe)
            elif self.shuffle is not None:
                kind, (ext, side, cfg, attach) = "shuffle", self._shuffle_ext(b, ctx)
            elif not self.steps:
                yield b  # a bare prologue carrier with nothing published
                continue
            else:
                kind, ext, side, cfg, attach = "plain", None, (), None, None
            t0 = time.perf_counter_ns()
            if kind == "plain" and self._noop:
                sel = b.device.sel
                values = tuple(b.device.values[c] for c in self.src)
                validity = tuple(b.device.validity[c] for c in self.src)
            else:
                sel, values, validity, rest = self._dispatch(b, kind, cfg, ext, side, node)
            dt = time.perf_counter_ns() - t0
            node.add("fused_batches", 1)
            node.add_split("elapsed_compute", dt, shares)
            nb = self._emit(b, sel, values, validity)
            if attach is not None:
                setattr(nb, *attach(rest))
            # the residual (re-wrap, anchor snapshot, payload) stays on the
            # stage node; the split and the residual go to the span
            # timeline with the same nanos (exec/metrics.py)
            total = time.perf_counter_ns() - t_all
            node.add("stage_wall", total)
            node.add("elapsed_compute", max(total - dt, 0))
            obs.note_op(node.name or "FusedStageExec", "elapsed_compute", max(total - dt, 0))
            yield nb


# ---------------------------------------------------------------------------
# segment planning
# ---------------------------------------------------------------------------


def _chain_ops():
    from auron_tpu_torch.exec.basic import FilterExec, ProjectExec, RenameColumnsExec

    return FilterExec, ProjectExec, RenameColumnsExec


def _op_safe(op: ExecOperator) -> bool:
    FilterExec, ProjectExec, RenameColumnsExec = _chain_ops()
    schema = op.children[0].schema
    if isinstance(op, FilterExec):
        return all(expr_capture_safe(p, schema) for p in op.predicates)
    if isinstance(op, ProjectExec):
        return all(expr_capture_safe(e, schema, allow_dict_out=True) for e in op.exprs)
    return isinstance(op, RenameColumnsExec)


def _collect_chain(op: ExecOperator):
    """Maximal stateless chain from ``op`` down: (ops top-down, source)."""
    chain = _chain_ops()
    ops = []
    cur = op
    while isinstance(cur, chain):
        ops.append(cur)
        cur = cur.children[0]
    return ops, cur


def _mirror_project_schema(exprs, names, schema: T.Schema) -> T.Schema:
    """The schema ``batch_from_columns`` stamps on a projection (a NULL-kind
    value surfaces as INT32)."""
    return T.Schema(tuple(
        T.Field(n, dt if (dt := e.dtype_of(schema)).kind != T.TypeKind.NULL else T.INT32, True)
        for e, n in zip(exprs, names)))


class _Segment:
    """Static description of one fusable run, built bottom-up."""

    def __init__(self):
        self.steps: list = []
        self.op_shares: list = []
        self.stamp: T.Schema | None = None
        self.src: list | None = None  # None = identity passthrough
        self.reads: set = set()
        self.n_ops = 0

    def _read(self, exprs) -> None:
        for e in exprs:
            for c in _columns(e):
                s = c if self.src is None else self.src[c]
                if s is not None:
                    self.reads.add(s)

    def add_filter(self, schema: T.Schema, preds: tuple) -> None:
        self._read(preds)
        self.steps.append(("filter", schema, preds))
        self.op_shares.append(("FilterExec", sum(_expr_nodes(p) for p in preds)))
        self.n_ops += 1

    def add_project(self, schema: T.Schema, exprs: tuple, names,
                    op_name: str = "ProjectExec") -> None:
        # a bare reference is a passthrough, not a read
        self._read([e for e in exprs if not isinstance(e, ir.Column)])
        self.steps.append(("project", schema, exprs))
        self.op_shares.append((op_name, sum(_expr_nodes(e) for e in exprs)))
        self.stamp = _mirror_project_schema(exprs, names, schema)
        prev = self.src
        self.src = [(e.index if prev is None else prev[e.index])
                    if isinstance(e, ir.Column) else None for e in exprs]
        self.n_ops += 1

    def add_rename(self, schema: T.Schema) -> None:
        self.stamp = schema
        self.n_ops += 1

    def cost(self) -> int:
        """Estimated eager per-batch dispatches the program replaces."""
        return sum(w for _, w in self.op_shares) + self.n_ops

    def build(self, child: ExecOperator, schema: T.Schema) -> FusedStageExec:
        return FusedStageExec(child, tuple(self.steps), self.stamp,
                              None if self.src is None else tuple(self.src),
                              tuple(sorted(self.reads)), tuple(self.op_shares), schema)


def _plan_segment(ops_top_down: list) -> _Segment:
    FilterExec, ProjectExec, _ = _chain_ops()
    seg = _Segment()
    for o in reversed(ops_top_down):
        schema = o.children[0].schema
        if isinstance(o, FilterExec):
            seg.add_filter(schema, tuple(o.predicates))
        elif isinstance(o, ProjectExec):
            seg.add_project(schema, tuple(o.exprs), o.names)
        else:
            seg.add_rename(o.schema)
    return seg


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def _should_fuse(cost: int, conf: Configuration, device: str, knob=FUSE_ENABLE) -> bool:
    """Fuse or materialise (reference ``fusion.py:929``): explicit on/off
    win; auto fuses every segment on CUDA, and on the CPU only segments
    whose estimated eager dispatch count reaches ``exec.fuse.min.ops``."""
    accel = torch.device(device).type == "cuda"
    return resolve_tri(conf.get(knob), accel or cost >= conf.get(FUSE_MIN_OPS))


def _safe_runs(ops: list) -> list:
    """A chain (top-down) as maximal runs tagged capture-safe or not: one
    unsafe expression splits the segment around it."""
    runs: list[tuple[bool, list]] = []
    for o in ops:
        ok = _op_safe(o)
        if runs and runs[-1][0] == ok:
            runs[-1][1].append(o)
        else:
            runs.append((ok, [o]))
    return runs


class _Pass:
    def __init__(self, conf: Configuration, device: str):
        self.conf = conf
        self.device = device
        #: segments this pass left eager, by reason
        self.eager: dict = {}

    def note_eager(self, reason: str) -> None:
        self.eager[reason] = self.eager.get(reason, 0) + 1
        _note_eager(reason)

    def fuse(self, cost: int, knob=FUSE_ENABLE) -> bool:
        return _should_fuse(cost, self.conf, self.device, knob)

    def rebuild_chain(self, runs: list, bottom: ExecOperator) -> ExecOperator:
        """Reassemble a chain over ``bottom``: each safe run that passes the
        cost model fused, the others as their operators."""
        cur = bottom
        for ok, run in reversed(runs):
            seg = _plan_segment(run) if ok else None
            if seg is not None and seg.steps and self.fuse(seg.cost()):
                cur = seg.build(cur, run[0].schema)
                continue
            if seg is None:
                self.note_eager("unsafe")
            elif seg.steps:
                self.note_eager("cost")
            for o in reversed(run):
                o.children[0] = cur
                cur = o
        return cur

    def fallback_chain(self, child: ExecOperator) -> ExecOperator:
        if isinstance(child, _chain_ops()):
            ops, source = _collect_chain(child)
            return self.rebuild_chain(_safe_runs(ops), self.visit(source))
        return self.visit(child)

    def chain_segment_below(self, child: ExecOperator):
        """(segment of the TOP safe run, remaining runs, source, its output
        schema); the segment may be empty (a bare carrier stage)."""
        ops, source = _collect_chain(child)
        runs = _safe_runs(ops)
        top_run = runs[0][1] if runs and runs[0][0] else []
        rest = runs[1:] if top_run else runs
        seg = _plan_segment(top_run)
        out_schema = top_run[0].schema if top_run else child.schema
        return seg, rest, source, out_schema

    def prefuse_agg(self, agg):
        """Extend the segment THROUGH a partial HashAggExec: its grouping and
        argument expressions join the stage program and the aggregate is
        rewritten over bare column refs (reference ``_try_prefuse_agg``)."""
        from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
        from auron_tpu_torch.exec.basic import EmptyPartitionsExec

        in_schema = agg.children[0].schema
        exprs = [g for g, _ in agg.groupings] + [a.expr for a, _ in agg.aggs
                                                 if a.expr is not None]
        if not exprs or not all(expr_capture_safe(e, in_schema, allow_dict_out=True)
                                for e in exprs):
            return None
        ops, source = _collect_chain(agg.children[0])
        runs = _safe_runs(ops)
        top_run = runs[0][1] if runs and runs[0][0] else []
        rest = runs[1:] if top_run else runs
        names = [n for _, n in agg.groupings] + [n for a, n in agg.aggs if a.expr is not None]
        seg = _plan_segment(top_run)
        seg.add_project(in_schema, tuple(exprs), names, op_name="HashAggExec")
        if not self.fuse(seg.cost()):
            return None
        new_groupings = [(ir.Column(i, n), n) for i, (_, n) in enumerate(agg.groupings)]
        k = len(agg.groupings)
        new_aggs = []
        for a, n in agg.aggs:
            if a.expr is None:
                new_aggs.append((AggExpr(a.func, None, udaf=a.udaf), n))
            else:
                new_aggs.append((AggExpr(a.func, ir.Column(k, n), udaf=a.udaf), n))
                k += 1
        # typing check before any side effect: the rewritten aggregate over
        # the stage's emitted layout must type exactly like the original
        probe = HashAggExec(EmptyPartitionsExec(seg.stamp, 1), new_groupings, new_aggs, agg.mode)
        if probe.schema != agg.schema or probe.inter_schema != agg.inter_schema:
            return None
        below = self.rebuild_chain(rest, self.visit(source))
        fused = seg.build(below, seg.stamp)
        new_agg = HashAggExec(fused, new_groupings, new_aggs, agg.mode)
        spec = _dense_prep_spec(new_agg)
        if spec is not None:
            link = DensePrepLink()
            fused.attach_dense_link(link, new_agg.n_keys, spec)
            new_agg._dense_prep_link = link
        return new_agg

    def probe_side(self, join, child: ExecOperator) -> ExecOperator:
        """Extend the stage feeding ``join``'s probe side through the probe
        prologue (reference ``_probe_side_rewrite``)."""
        from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

        d = join.driver
        if isinstance(child, BroadcastHashJoinExec) or d.condition is not None:
            return self.fallback_chain(child)
        probe_keys = d.left_keys if d.probe_is_left else d.right_keys
        seg, rest, source, out_schema = self.chain_segment_below(child)
        if not probe_keys or not all(expr_capture_safe(k, out_schema) for k in probe_keys):
            return self.fallback_chain(child)
        pcol_ids, bcol_ids = d._side_ids()
        probe_cost = sum(_expr_nodes(k) for k in probe_keys) + 6 + len(bcol_ids)
        if not self.fuse(seg.cost() + probe_cost, FUSE_PROBE):
            return self.fallback_chain(child)
        below = self.rebuild_chain(rest, self.visit(source))
        fused = seg.build(below, out_schema)
        link = ProbePrepLink()
        fused.attach_probe_link(link, tuple(probe_keys), d.probe_outer, tuple(pcol_ids),
                                tuple(bcol_ids), type(join).__name__, probe_cost)
        join._probe_prep_link = link
        return fused

    def writer_side(self, writer, child: ExecOperator) -> ExecOperator:
        """Extend the stage feeding a shuffle writer through the repartition
        prologue (reference ``_writer_side_rewrite``)."""
        spec = writer.partitioning.fuse_spec(child.schema)
        if spec is None:
            return self.fallback_chain(child)
        seg, rest, source, out_schema = self.chain_segment_below(child)
        key_exprs = spec[1] if spec[0] == "hash" else ()
        if not all(expr_capture_safe(e, out_schema) for e in key_exprs):
            return self.fallback_chain(child)
        n_out = writer.partitioning.num_partitions
        cost = sum(_expr_nodes(e) for e in key_exprs) + 4 + len(out_schema)
        if not self.fuse(seg.cost() + cost, FUSE_SHUFFLE):
            return self.fallback_chain(child)
        below = self.rebuild_chain(rest, self.visit(source))
        fused = seg.build(below, out_schema)
        fused.attach_shuffle(spec, n_out, cost)
        return fused

    def visit(self, op: ExecOperator) -> ExecOperator:
        from auron_tpu_torch.exec.agg_exec import PARTIAL, HashAggExec
        from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
        from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

        if isinstance(op, HashAggExec) and op.mode == PARTIAL and self.conf.get(FUSE_AGG_INPUTS):
            new = self.prefuse_agg(op)
            if new is not None:
                return new
        if isinstance(op, BroadcastHashJoinExec):
            pc = 1 if op.build_side == "left" else 0
            op.children[1 - pc] = self.visit(op.children[1 - pc])
            op.children[pc] = self.probe_side(op, op.children[pc])
            return op
        if isinstance(op, ShuffleWriterExec):
            op.children[0] = self.writer_side(op, op.children[0])
            return op
        if isinstance(op, _chain_ops()):
            ops, source = _collect_chain(op)
            return self.rebuild_chain(_safe_runs(ops), self.visit(source))
        for i, c in enumerate(op.children):
            op.children[i] = self.visit(c)
        return op


def _dense_prep_spec(agg) -> tuple | None:
    """Per-aggregate plane spec of the stage's dense-fold prep, or None when
    the aggregate cannot fold stage-prepped planes. Column indices address
    the stage's output layout (keys, then arguments in order)."""
    from auron_tpu_torch.exec.agg_exec import is_wide_sum, sum_type

    if not agg._dense_eligible():
        return None
    spec = []
    for (a, _), in_t in zip(agg.aggs, agg._agg_input_types):
        if a.func in ("sum", "avg"):
            if is_wide_sum(in_t):
                return None
            spec.append((a.func, in_t, sum_type(in_t)))
        else:
            spec.append((a.func,))
    return tuple(spec)


def _clone_tree(op: ExecOperator) -> ExecOperator:
    """A copy of the operator tree (nodes shallow-copied, children lists
    new): the pass rewrites the copy, so a tree shared by several tasks is
    fused once per task and never twice."""
    out = copy.copy(op)
    out.children = [_clone_tree(c) for c in op.children]
    return out


def fuse_exec_tree(plan: ExecOperator, conf: Configuration,
                   device: str = "cuda") -> ExecOperator:
    """Whole-stage fusion of an exec tree for a task on ``device`` (the
    cost model's substrate). Returns ``plan`` itself when
    ``exec.fuse.enable`` is off or the tree is already fused, else a fused
    copy; answers are bit-identical either way."""
    if not resolve_tri(conf.get(FUSE_ENABLE), True) or getattr(plan, "_fused", False):
        return plan
    p = _Pass(conf, str(device))
    out = p.visit(_clone_tree(plan))
    out._fused = True
    out._fusion_plan = {"segments": _count_stages(out), "eager": dict(p.eager)}
    return out


def _count_stages(op: ExecOperator) -> int:
    return int(isinstance(op, FusedStageExec)) + sum(_count_stages(c) for c in op.children)
