"""Typed configuration: the keys the ported slices read.

Copied from ``auron_tpu/utils/config.py`` (the ``ConfigOption`` /
``Configuration`` / ``resolve_tri`` / ``active_conf`` / ``conf_scope``
machinery, verbatim in behaviour) with only the keys the port reads. Keys
and values mean the same thing as in the JAX package, so a conf shipped by
a host engine in a ``TaskDefinition`` configures both engines alike.
Values resolve from (1) the session dict, (2) the env var
``AURON_TPU_<KEY>``, (3) the default.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")

_REGISTRY: dict[str, "ConfigOption"] = {}


@dataclass(frozen=True)
class ConfigOption(Generic[T]):
    key: str
    default: T
    parse: Callable[[str], T]
    category: str = "general"
    doc: str = ""

    def __post_init__(self):
        _REGISTRY[self.key] = self

    def get(self, conf: "Configuration | None" = None) -> T:
        c = conf if conf is not None else active_conf()
        return c.get(self)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def env_key_for(key: str) -> str:
    return "AURON_TPU_" + key.upper().replace(".", "_")


def int_conf(key: str, default: int, category: str = "general", doc: str = "") -> ConfigOption[int]:
    return ConfigOption(key, default, int, category, doc)


def float_conf(key: str, default: float, category: str = "general", doc: str = "") -> ConfigOption[float]:
    return ConfigOption(key, default, float, category, doc)


def bool_conf(key: str, default: bool, category: str = "general", doc: str = "") -> ConfigOption[bool]:
    return ConfigOption(key, default, _parse_bool, category, doc)


def str_conf(key: str, default: str, category: str = "general", doc: str = "") -> ConfigOption[str]:
    return ConfigOption(key, default, str, category, doc)


class Configuration:
    """Resolved key->value store with session overrides."""

    def __init__(self, values: dict[str, Any] | None = None):
        self._values: dict[str, Any] = dict(values or {})

    def set(self, opt: ConfigOption[T] | str, value: Any) -> "Configuration":
        key = opt if isinstance(opt, str) else opt.key
        self._values[key] = value
        return self

    def get(self, opt: ConfigOption[T]) -> T:
        if opt.key in self._values:
            v = self._values[opt.key]
            return opt.parse(v) if isinstance(v, str) else v
        env_key = env_key_for(opt.key)
        if env_key in os.environ:
            return opt.parse(os.environ[env_key])
        return opt.default

    def copy(self) -> "Configuration":
        return Configuration(self._values)

    def keys(self) -> list[str]:
        """The keys the session set (not defaults or env)."""
        return list(self._values)

    def items(self) -> list[tuple[str, Any]]:
        """The (key, value) pairs the session set (not defaults or env)."""
        return list(self._values.items())


_local = threading.local()
_GLOBAL = Configuration()


def active_conf() -> Configuration:
    return getattr(_local, "conf", None) or _GLOBAL


def resolve_tri(mode: str, auto: bool) -> bool:
    """on|off|auto knobs: explicit on/off win, auto defers to the caller's
    device predicate."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    return auto


class conf_scope:
    """Context manager installing a Configuration for the current thread."""

    def __init__(self, conf: Configuration):
        self.conf = conf

    def __enter__(self):
        self._prev = getattr(_local, "conf", None)
        _local.conf = self.conf
        return self.conf

    def __exit__(self, *exc):
        _local.conf = self._prev
        return False


# ---------------------------------------------------------------------------
# keys read by this slice (same keys, same defaults as auron_tpu)
# ---------------------------------------------------------------------------

BATCH_SIZE = int_conf(
    "batch.size", 131072, "exec", "target rows per columnar device batch",
)
SCAN_ZEROCOPY = str_conf(
    "exec.scan.zerocopy", "auto", "scan",
    "zero-copy ingestion (docs/shuffle.md): validity-clean fixed-width "
    "Arrow/numpy column buffers upload by 64-byte-aligned buffer ALIAS "
    "instead of a host->device copy (XLA:CPU device_put aliases aligned "
    "host memory; accelerators still DMA but skip the intermediate numpy "
    "materialization), validity/selection planes of full clean batches "
    "come from shared cached all-true planes, and dictionary pages pass "
    "through by reference. The engine relies on Arrow/ingest buffers "
    "staying immutable while device arrays reference them (Arrow buffers "
    "are immutable by contract; Batch.from_pandas documents the same "
    "contract for user frames). on | off | auto = on. off restores the "
    "copying ingest path exactly (bit-identical results either way). "
    "In the port (Batch.from_host_arrow) every plane still crosses one host "
    "copy, into its pinned staging buffer; the key only chooses between "
    "one host copy and two. On, a fixed-width plane whose Arrow layout is "
    "the device plane's is a view of the producer's buffer that goes "
    "straight to that staging copy (NULL lanes and padding are zeroed on "
    "the device, so neither NULLs nor a partial batch need a copy of their "
    "own); off first copies every plane into an owned array. Counted as "
    "zerocopy_planes / copied_planes",
)
JOIN_COMPACT_OUTPUT = str_conf(
    "join.compact.output", "auto", "join",
    "compact sparse unique-join outputs before gathering build columns: "
    "on | off | auto = on. The bucket comes from the selectivity predictor "
    "(exec.selectivity.predictor), so on CUDA the compaction costs no sync "
    "per batch: one blocking read seeds each probe stream, later live counts "
    "ride the transfer window (runtime.transfer.window.depth)",
)
SELECTIVITY_PREDICTOR_ENABLE = str_conf(
    "exec.selectivity.predictor", "auto", "exec",
    "predict the compacted-output capacity bucket from an EWMA of prior "
    "batches' live counts instead of blocking on a per-batch device_get "
    "(exec/selectivity.py; mispredicts repair via re-emit): on | off | "
    "auto = on wherever compaction itself is on",
)
SELECTIVITY_EWMA_ALPHA = float_conf(
    "exec.selectivity.ewma.alpha", 0.3, "exec",
    "EWMA weight of the newest batch's live count in the selectivity "
    "predictor (higher = faster tracking, more bucket churn)",
)
SELECTIVITY_HEADROOM = float_conf(
    "exec.selectivity.headroom", 1.5, "exec",
    "multiplier over the EWMA live count before bucketing the predicted "
    "capacity — absorbs batch-to-batch selectivity noise without a "
    "mispredict/repair cycle",
)
SELECTIVITY_SHRINK_PATIENCE = int_conf(
    "exec.selectivity.shrink.patience", 4, "exec",
    "consecutive batches the demand must sit at half the predicted bucket "
    "(or less) before the predictor shrinks it — hysteresis so an "
    "oscillating selectivity doesn't thrash buckets (and jit shapes)",
)
TRANSFER_WINDOW_DEPTH = int_conf(
    "runtime.transfer.window.depth", 4, "runtime",
    "depth k of the async device->host transfer window: residual scalar "
    "reads (compaction live counts, dense-agg fold flags) are harvested k "
    "batches after their transfer starts, overlapping device compute "
    "(runtime/transfer.py). 1 = classic one-deep pipeline",
)
HOST_SORT_MODE = str_conf(
    "exec.host.sort", "auto", "exec",
    "kept so a conf from the host engine parses; the port reads it nowhere "
    "and always sorts where its tensors live",
)
DEVICE_SORT_IMPL = str_conf(
    "exec.device.sort.impl", "auto", "exec",
    "cluster-sort implementation when sorting on the device: lax = stable "
    "multi-pass torch.sort lexsort; jnp = the bitonic network in plain "
    "torch; pallas = the hand-written CUDA bitonic kernels (the plain "
    "network for CPU tensors); auto = pallas on CUDA when P >= 2048, else lax",
)
PARTIAL_AGG_SKIPPING_ENABLE = bool_conf(
    "partial.agg.skipping.enable", True, "agg",
    "skip partial aggregation when observed cardinality ratio is high",
)
PARTIAL_AGG_SKIPPING_RATIO = float_conf("partial.agg.skipping.ratio", 0.8, "agg", "")
PARTIAL_AGG_SKIPPING_MIN_ROWS = int_conf("partial.agg.skipping.min.rows", 20480, "agg", "")
AGG_INCREMENTAL_ENABLE = bool_conf(
    "exec.agg.incremental.enable", True, "agg",
    "umbrella for fingerprint-sort segmentation (False = full-word sort)",
)
AGG_INCREMENTAL_FINGERPRINT = str_conf(
    "exec.agg.incremental.fingerprint", "auto", "agg",
    "sort (dead, fingerprint64, iota) instead of every key word: "
    "on | off | auto = on for CUDA tensors, off for CPU tensors",
)
AGG_INCREMENTAL_PROBE = str_conf(
    "exec.agg.incremental.probe", "auto", "agg",
    "binary-search each incoming row into the fingerprint-sorted state "
    "batch and scatter-add rows whose group already exists straight into "
    "the state accumulators (exec/agg_exec.py _ProbeScatter); only miss "
    "rows flow to sort-segmentation. on | off | auto = CUDA tensors only "
    "(the reference's accelerators-only default)",
)
AGG_INCREMENTAL_MERGEPATH = str_conf(
    "exec.agg.incremental.mergepath", "auto", "agg",
    "merge fingerprint-sorted state and staged runs with a binsearch "
    "merge-rank permutation instead of concat-and-re-sort; the full "
    "re-sort stays whenever a run is not confirmed collision-free. "
    "on | off | auto = CUDA tensors only",
)
AGG_INCREMENTAL_FP_BITS = int_conf(
    "exec.agg.incremental.fp.bits", 64, "agg",
    "fingerprint width; < 64 truncates (a test hook forcing collisions)",
)
FILTER_FUSE = bool_conf(
    "exec.filter.fuse", True, "exec",
    "run a capture-safe FilterExec's predicate chain as ONE program per "
    "(schema, predicates, capacity bucket): a CUDA graph replayed per batch "
    "on the card, the same function eagerly on the CPU. Subsumed by "
    "exec.fuse.* when the filter sits inside a fused segment",
)
FUSE_ENABLE = str_conf(
    "exec.fuse.enable", "auto", "fusion",
    "whole-stage fusion (plan/fusion.py): each maximal scan->filter->"
    "project->partial-agg-input segment between blocking boundaries runs "
    "as ONE program per (schema, segment signature, capacity bucket), "
    "captured once as a CUDA graph and replayed. on | off | auto = fuse "
    "every capture-safe segment on CUDA, and on the CPU only segments whose "
    "estimated eager-dispatch count reaches exec.fuse.min.ops. Results are "
    "bit-identical either way",
)
FUSE_MIN_OPS = int_conf(
    "exec.fuse.min.ops", 2, "fusion",
    "cost-model threshold on the CPU under exec.fuse.enable=auto: a segment "
    "fuses only when the eager path would cost at least this many per-batch "
    "dispatches (expression DAG nodes + one per constituent operator)",
)
FUSE_AGG_INPUTS = bool_conf(
    "exec.fuse.agg.inputs", True, "fusion",
    "extend fused segments THROUGH a partial-mode HashAggExec's input "
    "evaluation: grouping and aggregate argument expressions run in the "
    "segment program and the aggregate consumes bare column refs (gated by "
    "the same cost model)",
)
FUSE_PROBE = str_conf(
    "exec.fuse.probe", "auto", "fusion",
    "extend the fused stage feeding a hash join's probe side THROUGH the "
    "probe prologue: key evaluation, canonical words, the unique/existence "
    "lookup and the build-row gather or predicted compact-take run in the "
    "SAME stage program. The mispredict-repair protocol and finish_probe "
    "are unchanged. on | off | auto = CUDA always, CPU when the segment "
    "cost model fuses",
)
FUSE_SHUFFLE = str_conf(
    "exec.fuse.shuffle", "auto", "fusion",
    "extend the fused stage feeding a ShuffleWriterExec THROUGH the "
    "repartition prologue: partition ids (K1 for a single int64 key) and "
    "the pid clustering ride the stage program. on | off | auto = same "
    "cost-model split as exec.fuse.enable",
)
METRICS_ROW_COUNTS = bool_conf(
    "metrics.row.counts", False, "runtime",
    "per-operator output_rows metrics (one device count read per operator)",
)
TOKIO_EQUIV_PREFETCH_DEPTH = int_conf(
    "runtime.prefetch.depth", 2, "runtime", "batches prefetched by the task pump",
)
TASK_SLOTS = int_conf(
    "runtime.task.slots", 1, "runtime",
    "concurrent task slots a stage's tasks run on (models/tpcds.run_tasks_parallel: "
    "a thread each, and on the card a CUDA stream each); 1 runs them one after another",
)
MEMORY_FRACTION = float_conf(
    "memory.fraction", 0.6, "memory", "fraction of HBM budget usable by consumers"
)
HBM_BUDGET_BYTES = int_conf(
    "memory.hbm.budget.bytes", 0, "memory",
    "total device bytes the memory manager may hand out (analog of native "
    "memory = overhead * fraction, which the reference derives from the "
    "executor's provisioned memory). 0 = auto: the card's own memory when "
    "CUDA is available (torch.cuda.get_device_properties().total_memory, "
    "80 GB on an H100, where the JAX package's auto takes its TPU's 8 GB), "
    "half of physical RAM otherwise (CPU tensors ARE host memory)",
)
SPILL_COMPRESSION_CODEC = str_conf(
    "spill.compression.codec", "lz4", "memory",
    "codec for spill files and shuffle runs (zstd|lz4|none), through "
    "pa.Codec; an unavailable one degrades (warned once)",
)
HOST_SPILL_BUDGET_BYTES = int_conf(
    "memory.host.spill.budget.bytes", 2 << 30, "memory",
    "host-RAM bytes the spill ledger may keep resident before demoting the "
    "coldest HostSpills to disk (the host tier of HBM -> RAM -> disk)",
)
MEM_WAIT_TIMEOUT_S = float_conf(
    "memory.wait.timeout.seconds", 10.0, "memory",
    "how long a below-fair-share consumer waits for siblings to release "
    "memory before it is forced to spill (auron-memmgr lib.rs WAIT_TIME)",
)
SHUFFLE_COMPRESSION_TARGET_BUF_SIZE = int_conf(
    "shuffle.compression.target.buf.size", 4 << 20, "shuffle",
    "staged raw bytes per reduce partition before the writer encodes a block",
)
SHUFFLE_ENCODING = str_conf(
    "exec.shuffle.encoding", "auto", "shuffle",
    "shuffle block format v2 (per-column light-weight encodings): on | off | "
    "auto = on; off writes v1 blocks (Arrow IPC under spill.compression.codec)",
)
SHUFFLE_ENCODING_DICT_MAX = int_conf(
    "exec.shuffle.encoding.dict.max", 4096, "shuffle",
    "largest dictionary a v2 block carries for a dictionary column",
)
SHUFFLE_ENCODING_FALLBACK = str_conf(
    "exec.shuffle.encoding.fallback.codec", "auto", "shuffle",
    "general codec for planes no light-weight encoding fits (zstd|lz4|none|"
    "auto = spill.compression.codec); unavailable codecs degrade to the "
    "light-weight encodings with one stderr warning",
)
EXCHANGE_MODE = str_conf(
    "exchange.mode", "auto", "shuffle",
    "transport for planned mesh_exchange nodes: mesh (device-resident; the "
    "port's P partitions share one card) | file (durable shuffle files) | "
    "auto (mesh when the hottest receiving shard's payload fits "
    "exchange.mesh.max.bytes)",
)
EXCHANGE_COALESCE_ENABLE = bool_conf(
    "exchange.coalesce.enable", True, "shuffle",
    "AQE post-shuffle coalescing: group small reduce partitions from "
    "map-output statistics (CoalesceShufflePartitions analog)",
)
EXCHANGE_COALESCE_TARGET_BYTES = int_conf(
    "exchange.coalesce.target.bytes", 64 << 20, "shuffle",
    "target bytes per coalesced reduce partition",
)
EXCHANGE_MESH_MAX_BYTES = int_conf(
    "exchange.mesh.max.bytes", 2 << 30, "shuffle",
    "auto-mode ceiling for device-resident exchange payload per shard; "
    "larger exchanges take the durable file path",
)
EXCHANGE_SKEW_ENABLE = bool_conf(
    "exchange.skew.join.enable", True, "shuffle",
    "AQE skew-join splitting: a reduce partition much larger than the "
    "median splits into map-range slices joined against the full other "
    "side (Spark OptimizeSkewedJoin analog)",
)
EXCHANGE_SKEW_FACTOR = float_conf(
    "exchange.skew.join.factor", 5.0, "shuffle",
    "a partition is skewed when its bytes exceed factor x median",
)
EXCHANGE_SKEW_MIN_BYTES = int_conf(
    "exchange.skew.join.min.bytes", 64 << 20, "shuffle",
    "partitions below this never count as skewed",
)
AGG_PARTIAL_DEFER = str_conf(
    "exec.agg.partial.defer", "auto", "agg",
    "defer the PARTIAL generic path's per-batch (live count, group "
    "count, collision flag) read through the k-deep async transfer "
    "window (runtime.transfer.window.depth) instead of blocking one "
    "device_get per batch: the upstream probe/stage pipeline dispatches "
    "ahead while counts ride host-ward, compaction buckets are chosen "
    "by the selectivity predictor and a truncating mispredict recomputes "
    "the reduce from the still-held batch (row-exact and count-exact; "
    "float accumulations may re-associate across the re-bucketed "
    "reduces, the same class of difference as any merge-boundary "
    "shift). Applies only "
    "when no host-side aggregates and no sorted-state probe are active "
    "(the probe path owns its own window and stream-order contract). "
    "Up to k batches' intermediates stay accounted to the memory manager "
    "(unspillable) while in flight. on | off | auto = on (the stall, not "
    "the transfer, is the cost on every substrate — the q93-class 38s "
    "drain at agg_exec.py:427). off restores the eager one-read-per-"
    "batch protocol bit-identically",
)
UDF_FALLBACK_ENABLE = bool_conf(
    "udf.fallback.enable", True, "expr",
    "evaluate unconvertible expressions via host callback (SparkUDFWrapper analog)",
)
IGNORE_CORRUPTED_FILES = bool_conf(
    "files.ignore.corrupted", False, "scan", "tolerate unreadable input files (conf.rs:37)"
)
PARQUET_MAX_OVER_READ_SIZE = int_conf(
    "parquet.max.over.read.size", 16 << 20, "scan",
    "read coalescing window for remote-FS parquet reads (conf.rs:44)",
)
PARQUET_LATE_MATERIALIZATION = bool_conf(
    "parquet.late.materialization", True, "scan",
    "decode predicate columns first and skip the wide decode for row "
    "groups with zero matches (page/dictionary-check analog)",
)
