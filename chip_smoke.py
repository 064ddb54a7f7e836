#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (auron_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: every query class at SF 8
    python3 chip_smoke.py --sf 0.5   # smaller end-to-end phases
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of one run of each query
    python3 chip_smoke.py --window-only  # phases 1, 2 and 11 only
    python3 chip_smoke.py --join-tail-only  # phases 1, 2 and 13 only
    python3 chip_smoke.py --decimal-only  # phases 1, 2 and 14 only
    python3 chip_smoke.py --fusion-only  # phases 1, 2 and 15 only
    python3 chip_smoke.py --generate-only  # phases 1, 2 and 16 only
    python3 chip_smoke.py --bridge-only  # phases 1, 2 and 17 only
    python3 chip_smoke.py --plan-ir-only  # phases 1, 2 and 18 only
    python3 chip_smoke.py --convert-only  # phases 1, 2 and 19 only
    python3 chip_smoke.py --files-only  # phases 1, 2 and 20 only
    python3 chip_smoke.py --collect-only  # phases 1, 2 and 21 only
    python3 chip_smoke.py --udf-shuffle-only  # phases 1, 2 and 22 only
    python3 chip_smoke.py --sql-only  # phases 1, 2 and 23 only
    python3 chip_smoke.py --serve-only  # phases 1, 2 and 24 only
    python3 chip_smoke.py --stream-only  # phases 1, 2 and 25 only
    python3 chip_smoke.py --spmd-only  # phases 1, 2 and 26 only
    python3 chip_smoke.py --gate-only  # phases 1, 2 and 27 only

Phases, in order, none of them caught — any failure exits non-zero. Every
class of phases 4-16 and 21-22 starts each task from its ``TaskDefinition``
bytes (the reference function's plan from ``plan/builders.py``), and each
class line prints the run's summed ``task_bytes``, ``decode_s`` and
``plan_s`` (a line fails if no task of its run started from bytes); the
driver's runs (phases 7 and 9) take their plan protos whole.

1. identify the card (torch device name + the nvidia-smi name/power line);
2. build every CUDA source of the port (one nvcc per source, started
   together) and print the build seconds;
3. hold each kernel against its plain PyTorch version, bit for bit:
   ``bitonic_sort`` (K3) and ``bitonic_merge`` (K4, on bitonic inputs),
   also against a numpy stable lexsort, at every plane count from 2 to
   one past the largest register kernel (17: the general kernels) x P in
   {1024, 2048, 8192, 16384, 32768, 65536} with tie-heavy, equal-leading-plane,
   pre-sorted and reverse-sorted inputs in turn, and once each at
   2^20 x 8, 2^18 x 13 and 2^18 x 17 planes (the multi-stride merge
   launches, the general kernels); the operand-level ``bitonic_sort``
   (int32 planes split and joined on the card) at padded lengths (cap =
   P - 3) and mixed word kinds against the plain network and the library
   lexsort; the partition-id kernel ``murmur3_pmod``
   (K1) at n in {1, 1000, 2^20, 2^20 + 37, 5.76 M} rows x n_parts in
   {1, 3, 4, 200, 4096}, 85 % and 0 % NULL keys, with INT64_MIN, INT64_MAX,
   0 and -1 among the keys, and the routing histogram kernel
   ``partition_histogram`` (K2) at n in {0, 1, 1000, 2^20 + 37, 5,767,168,
   23,040,000} x n_parts in {1, 2, 4, 8, 200, 4096, one past its
   shared-memory branch} x 0 %, 50 % and 100 % live rows, with -1, n_parts,
   INT32_MIN and INT32_MAX among the ids (also against numpy's bincount);
   first ("3 (timing)", with the card to this process alone, before the
   second process below starts), time kernels, plain versions and library
   calls with CUDA events, and
   every bitonic launch's device time with torch.profiler (bitonic at
   16384 x 8, 16384 x 11, 8192 x 11, 2^20 x 8, 2^23 x 8, 2^24 x 8 and
   2^25 x 5 planes, the 2^23 and 2^24 shapes q72's probe-side sorts, the
   2^25 one q17's; K1 at 2^20 rows,
   4 partitions; K2 at a q93 map shard, 8,388,608 rows of which 5,760,000
   live, 4 partitions, ~89 % to one);
4. generate the data once (all later phases share it) and drive the
   q42-class query (scan -> broadcast hash join -> partial and final hash
   aggregate -> SortExec with fetch 10) end to end on ``cuda`` from its
   TaskDefinition bytes (as phases 5 and 6 start every task), check it
   against the numpy oracle (brand and order exact, revenue at rel 1e-9),
   and require that the SortExec launched exactly
   the bitonic kernels that ``sort_plan`` lists for the sort shapes the
   warm-up recorded (one cluster launch of K3 at 16,384 x 8); print its
   ``SortExec.sort_time`` host timer;
5. the q93-class query: map tasks (scan -> CASE key -> file shuffle on one
   nullable int64 key, ~85 % NULL) then reduce tasks (shuffle read -> left
   broadcast hash join -> partial and final aggregate by key IS NULL),
   4 map x 4 reduce; a warm-up run, then a timed run, each in its own
   temporary directory; rows and matched exact and s at rel 1e-9 against
   the numpy oracle, and the shuffle writer must have launched K1;
6. the q3-class query (two inner broadcast hash joins -> partial aggregate
   -> file shuffle on two int32 keys -> final aggregate -> driver top-k),
   4 x 4, warm-up then timed; keys and order exact, s at rel 1e-9;
7. q93-mesh and q3-mesh: the same two queries as one plan each through the
   planned-exchange driver (``parallel/mesh_driver.py``) on P = 4 logical
   partitions of the card, once with ``exchange.mode`` = mesh (device-
   resident exchange) and once = file; q3 then runs its single-task
   collect stage (SortExec fetch 100 -> LimitExec 100). Each mode gets a
   warm-up and a timed run; every answer equals its oracle and the two
   transports agree; K2 must launch exactly P times in every timed run, K1
   in q93's, and q3's bitonic launches must equal ``sort_plan``'s for its
   collect sort. The operands of q3's collect sort, recorded
   in the warm-up run, go through K3/K4 and through the plain network on
   the card once more, bit for bit (the kernels at the main path's own
   shapes). The routing matrix, mode, slot capacity, stage walls and peak
   device memory are printed;
8. the six shuffle-heavy gate classes this slice adds, 4 map x 4 reduce
   over the same fact partitions: q72 (both facts shuffled on item, a
   sort-merge join on (item, date), aggregate) once with
   ``auron.smj.elide.sorts`` = full and once = build (the probe side's
   SortExec then sorts ~5.76 M rows a reduce partition through K3 and K4,
   P = 2^23), q95 (left-semi broadcast joins below two exchanges, a
   left-anti join above), q18, q14 (two chained exchanges), q65 and q5
   (a union of two exchanges). Each gets a warm-up and a timed run and
   equals its numpy oracle (keys and counts exact, float sums and averages
   at rel 1e-9); the sorts recorded in the warm-up go through K3/K4 and the
   plain network on the card once more, bit for bit; the timed run's
   bitonic launches equal ``sort_plan``'s for those sorts, and K1 must
   launch in every class with a single-INT64-key shuffle. Walls, stage
   walls, shuffle bytes, launches and peak device memory are printed;
9. sort-merge join stages through the planned-exchange driver: q72-mesh
   (both facts through a mesh exchange on item into the SMJ stage, a third
   exchange before the final aggregate) at P = 4 on the mesh and the file
   transport, equal to the q72 oracle and to each other; then the skew plan
   (``tpcds.skew_join_plan``: 2^20 x SF fact rows, 8,388,608 at SF 8, 70 %
   on one key) on the
   file transport with AQE skew-join splitting on and off: the hot
   partition must split (more than P skew tasks), and both answers equal
   the oracle. K2 must launch once per source shard of every exchange;
10. the 22 expression-tail and join-tail classes (``tpcds.TAIL_CLASSES``:
   CASE, IN, LIKE, residual join conditions, a three-way sort-merge join
   chain, CTE reuse, set operations), each the reference function's plan
   with its partition and task counts over the same data: a warm-up and a
   timed run,
   each equal to its numpy oracle (keys, counts and order exact, float sums
   and averages at rel 1e-9). The sorts recorded in the warm-up go through
   K3/K4 and the plain network on the card once more, bit for bit (q17's
   two probe-side sorts, in spilled runs of 2^23 rows, and the K4 merges
   of those runs); the timed run's bitonic launches equal ``sort_plan``'s
   for them; q17 must launch K3 and K4, q16 (a file
   shuffle on the nullable INT64 customer) K1, and q41 with
   ``exec.agg.incremental.fingerprint`` = off K3 (its full-word grouping
   sort; by default a dictionary-keyed grouping sorts a fingerprint with
   the library sort). Wall, top host timers, launches and peak device
   memory are printed for each;
11. the eight window, expand and scalar-subquery classes
   (``tpcds.WINDOW_CLASSES``) over the whole fact table with the reference
   functions' plans and task counts: windowed (an aggregate on
   (date, item), rank() by revenue within the date), windowed2 (lag and a
   running sum by item over date on the fact de-duplicated on (item,
   date)), q51 (a running sum over a join's aggregate), q23 and q46 (rank
   over a join's aggregate, top 3), q67 and q67b (ROLLUP and CUBE through
   one ExpandExec: 3 and 4 x 23.04 M rows into the aggregate) and q9 (a
   global-average subquery task, then a filter on ScalarSubquery). Each
   gets a warm-up, whose kernel sorts go through K3/K4 and the plain
   network on the card once more, bit for bit, then a timed run (two
   under ``--window-only``), whose bitonic launches equal ``sort_plan``'s
   for those sorts;
   every windowed class must launch K3, and K4 where a sort is past one
   cluster. Each answer equals its numpy oracle (keys, counts, ranks, lag
   values and order exactly, revenues and sums at rel 1e-9, running sums
   within 1e-9 |want| + 16 eps of the global prefix, windowed's ranks under
   its tie rule); walls, top host timers, launches, sort shapes, the
   aggregate path, the running sums' largest error and peak device memory
   are printed;
12. the spill paths (memory/memmgr.py and its consumers). Under the
   default conf (the card's memory as the budget) a SortExec spills its
   pending run at 2^23 live rows: phase 10's q17 sorts 23.04 M rows in
   runs of 2^23, merged on the card by K4 (each run merge's planes held
   against the plain network on the card, bit for bit, like the sorts;
   phases 8-11 record both); phase 8's q72 (build) partitions stay under
   the threshold. The phase prints their spilled runs, merge time, wall
   and peak beside their numbers before the spill path. Then three
   classes under a ``memory.hbm.budget.bytes`` each (SPILL_RUNS): q67
   (its aggregate parks runs in host RAM, demoted to disk past a 128 MiB
   host ledger), q72 (build) (its probe-side sort spills by memory) and
   q93 (every map task's shuffle staging parks blocks in .shuffle.spill
   files; K1 as often as unbudgeted), each with only its own inputs on
   the card: a warm-up whose kernel sorts and run merges are checked on
   the card, one timed run without the budget, then one under it, each
   equal to the oracle and to the unbudgeted answer, with at least two
   spills; wall, peak, spill and wait counts, spill counters and timers,
   host-ledger demotions and the bytes parked on host and disk are
   printed;
13. the join tail and the sync-free compaction boundary: q33 (two
   aggregate branches of the whole fact FULL OUTER joined by item) in a
   warm-up and three timed runs, each equal to its oracle; the join-tail
   sweep: the fact's rows with ss_item_sk < 13,500 joined with build U (the
   items with an even i_item_sk, 9,000 unique keys, those from 13,500 up
   unmatched) and build D (U twice) by every join type, through the
   broadcast hash join with the build on the right and on the left and
   through the sort-merge join over SortExec inputs (K3/K4, their sorts
   and run merges held against the plain network on the card for the
   first case of each build), each held against a numpy oracle (rows,
   NULL-extended rows on each side, key and value sums); the predictor A/B:
   q42, q3, q6 and q18 with ``exec.selectivity.predictor`` on and off,
   bit-identical under torch's deterministic algorithms, then a timed
   run of each mode equal to the oracle, where every unique-join probe
   stream makes exactly one blocking read with the predictor on;
14. the decimal paths (``tpcds.DECIMAL_CLASSES``) over the same data:
   q9b (20,000 decimal(38,4) amounts, partial and final sum/min/max/count
   in one task, the overflowing group NULL), q3 with TPC-DS's money type
   (its decimal(17,2) partial sums cross the file shuffle as DEC128
   planes) and q42 with a wide sum (``sum(price * quantity)``,
   decimal(28,2) in base-1e9 limbs, and a decimal(11,6) avg; its top-10
   sort one K3 launch), two timed runs each, and the windowed class over
   decimal(17,2) revenues (K3 1, K4 27), one timed run; each after a
   warm-up whose kernel sorts go through K3/K4 and the plain network on
   the card once more, bit for bit. Every answer equals its exact oracle
   (decimals compare exactly); walls, peaks, the K3/K4 launches and the
   DEC128 columns written are printed;
15. slice 11's A/B: q42, q3, q93, q18, q33, q5, the decimal q42 and
   q3-mesh (FUSION_PATHS) with the defaults (whole-stage fusion as CUDA
   graphs, the incremental probe and merge-path, as auto resolves on the
   card) and with every key of the slice off (FUSION_OFF): per mode a
   warm-up, a timed run and, for q42, q3 and the decimal q42 (every path
   with ``--profile``), one profiled run, every answer equal to the
   oracle and the two modes' answers equal to each other (exact types bit
   for bit, float sums at rel 1e-9); the timed run captures no
   graph, q42 and q3 replay fused stages; walls, captures, replays,
   segments left eager by reason, graph bytes, peak memory, device idle
   share and each aggregate's paths (dense, probe, generic batches, probe
   hit rows, merge-path merges) are printed, and the decimal q42's cub
   sorts. Then the probe class (``tpcds.run_probe_agg_class``: a generic
   aggregate of the whole fact by (item, date), 32.85 M slots) both ways,
   equal to its numpy oracle, whose final aggregate must hit its sorted
   state;
16. the generate classes (``tpcds.GENERATE_CLASSES``): the reference's
   42nd class (``explode(split(i_tags, ','))`` over item, count by tag)
   and the same explode over the whole fact after a broadcast join with
   item (23.04 M fact rows in 22 input batches, ~46 M exploded rows in
   ~700 chunks of 65,536, count and price sum by tag): a warm-up, then a
   timed run each, equal to the numpy oracle, exploding exactly the rows
   the data holds with one blocking read of the GenerateExec per input
   batch; walls, input batches, output chunks, exploded rows, the blocking
   reads, peak device memory and the top host timers are printed (with
   ``--profile``, device busy and the idle share). No kernel of the
   TPU package is on this path;
17. the host boundary: q42 and q93 (4 x 4) with their inputs on the card
   (the device runners, ingest as set-up) and through the boundary
   (``tpcds.run_q42_bridge`` / ``run_q93_bridge``: the fact and the
   dimensions as host Arrow batches handed over as Arrow C streams, taken
   in by ``ffi_reader``s through pinned staging, q42's answer out as
   ``ipc_writer`` blocks, q93's reduce answers through ``next_batch_c``; a
   host clock around all of it; q42 also with ``exec.scan.zerocopy`` off,
   which copies every plane into an owned array before its staging copy):
   a warm-up each way, then a timed run each, every answer equal to its
   oracle, each boundary run launching K1 and K3 as its card run does. Walls, ingest seconds and bytes and GB/s,
   the zero-copy and copied planes, egress, K1/K3 launches, stage walls and
   peak device memory are printed (with ``--profile``, one profiled run of
   each through the boundary: device busy and the idle share);
18. the plan IR without google.protobuf and the C host: q42, q93 (4 x 4)
   and q3 (4 x 4) from their TaskDefinition bytes through
   ``bridge.api.call_native`` in this process (phases 4-6 start the same
   way now): a warm-up, then two timed runs each, q42 also from its
   prebuilt exec tree in turns with the bytes; every answer equal to its
   oracle, K3 1 (q42), K1 24 (q93), none for q3, q42's kernel sorts held
   against the plain network at their own operands. Then the port's C ABI
   (``csrc/auron_bridge.cpp`` with g++, ``csrc/bridge_harness.c`` with
   cc): q42 once through a separate ``bridge_harness`` process (its
   inputs as Arrow IPC resources, its answer as the harness's IPC batches;
   K3 1 by the process's counts), q93 through the library loaded into
   this process with ctypes (map tasks write shuffle files, reduce tasks
   read them through a ``shuffle:`` manifest; warm-up and a timed run,
   K1 24) and once through four harness processes (the two map tasks at
   once, then the two reduce tasks; K1 once a fact batch, 22, by their
   counts), each equal to its oracle. Every TaskDefinition the phase made
   decodes and re-encodes to the same bytes in the port's codec, and
   google.protobuf is not loaded (the phase runs with the shuffle's
   general codec off and pyarrow blocked, ``_without_pyarrow``, as phase
   19). Walls, task bytes, decode and planning
   seconds, the harness process's start (imports, CUDA init) against its
   task, resource bytes and launches are printed;
19. the host-plan converters (``convert/``, ``bridge.api.convert_plan_json``):
   q42, q93 (4 x 4) and q3 (4 x 4) from the host-plan JSON a Spark shim
   sends, converted, then the response's stages run task by task from
   their TaskDefinition bytes (map outputs committed to a ShuffleManager
   and handed over as manifests); the converted q93 segment under the
   planned-exchange driver (mode mesh, P = 4); the range-partitioned
   global sort of the projected fact (23.04 M rows, 4 x 4, bounds sampled
   as the shim's RangeBoundsSampler samples them; each reduce partition
   sorted through K3/K4); q93's host plan through one ``bridge_harness
   --convert`` process (its response equal to the in-process one, the
   stage namespace replaced) and that response's stages through the
   library loaded in this process. Each a warm-up, then a timed run;
   every answer equal to its oracle (the range sort: each partition
   ordered, every row between its bounds by Spark's rule, the four columns
   together the fact's rows after a full lexsort by library sorts on the
   card), K3 1 (q42), K1 24 (q93), K1 4 and K2 4 (q93-mesh), the range
   sort's K3/K4 as ``sort_plan`` lists for its sorts, which (and q42's)
   go through the plain network on the card once more, bit for bit.
   convert_s, response bytes, walls, stage walls, each task's decode and
   planning seconds, rows per partition, the range sort's sort, compress
   and decode timers and peak memory are printed; the phase fails if
   google.protobuf or pyarrow was loaded. It runs with
   ``exec.shuffle.encoding.fallback.codec`` = none (the codec is
   ``pa.Codec``'s) and, where an earlier phase's lz4 shuffle loaded
   pyarrow, with pyarrow blocked in ``sys.modules``;
20. the Parquet and ORC sinks and scans (``exec/sink.py``,
   ``exec/scan.py``), into a temporary directory on local disk that the
   phase removes: first the sinks' egress (``Batch.to_arrow``) against a
   pyarrow build of each column (``tests/torch_arrow.pyarrow_egress``)
   over the fact's batches, in turns, every batch equal; then the fact (4
   map tasks, 4 files), item, date_dim and customer written as Parquet,
   the fact as ORC and item Hive-partitioned by i_category, each through
   its converted ``DataWritingCommandExec`` host plan over the tables on
   the card and each read back with pyarrow against the numpy tables (the
   Hive directory names by the reference's escaping, the rows per
   directory numpy's); the sorted write (``df.orderBy(date, item).write``:
   the range sort under a ``DataWritingCommandExec``, 4 date-ordered
   files, its K3/K4 sorts held against the plain network on the card bit
   for bit, its launches as ``sort_plan`` lists, the files equal to the
   range sort's oracle); then q42, q93 and q3 from the Parquet files, q42
   from the ORC fact and q3 over the sorted files with a pushed filter of
   the five Novembers' ``ss_sold_date_sk`` ranges (``row_groups_pruned``
   above 0), each through its ``FileSourceScanExec`` host plan: a warm-up,
   then a timed run, every answer equal to its oracle, K3 1 (q42), K1
   24 (q93). Walls against phase 19's in-memory walls, write walls, bytes
   written, the scans' ``io_time``/``upload_time``, the ingest and pruning
   counters and peak memory are printed; a missing ``pyarrow.orc`` fails
   the phase;
21. the customer-basket class (collect_set of d_year and i_category_id,
   collect_list of the single-quantity items by ss_customer_sk, the NULL
   customer a group; a named_struct, a map_from_arrays and the top 100 by a
   MAP lookup), 4 map x 4 reduce over the file shuffle of the LIST states,
   then one task's SortExec over the reduce tasks' tops, every task from
   its TaskDefinition bytes: a warm-up (its kernel sorts held against the
   plain network on the card, bit for bit), then a timed run, each
   answer equal to the numpy oracle (keys, struct fields, map entries and
   every set exactly, every list as a multiset), K1 and K3 launched as
   ``sort_plan`` lists for the recorded sorts; the answer's STRUCT, MAP and
   LIST columns exported through the C data interface and read back in
   pyarrow equal to the oracle. Walls, the aggregate's ``elapsed_compute``,
   the shuffle's bytes, ``compress_time`` and ``decode_time`` and the peak
   memory are printed;
22. the host callbacks and the shuffle tail (``bridge/udf.py``, the codecs,
   ``exec/shuffle/rss*.py``, concurrent task slots), after phases 19-21
   because it loads pyarrow: (a) q93 and q72 (full) at the reference's
   default shuffle conf (the lz4 fallback codec) and without the codec,
   q93 under zstd, and q5 both ways (its raw float planes are the runs'
   codec planes: q93's and q72's all fit light-weight encodings); (b) q93
   with ``exec.shuffle.encoding=off`` (v1 lz4 Arrow IPC blocks); (c) q93
   through ``RssShuffleWriterExec`` to an ``RssNetServer`` on 127.0.0.1
   with 2 replicas, read through ``RemoteBlockProvider``; (d) q93 and q72
   with their map and reduce tasks on 4 slots (a CUDA stream each) against
   one after another, the same K1 counts, then q93 on 4 slots under a
   memory budget that makes each map task spill; (e) ``run_udf_class``: a
   Python UDF in q42's converted host plan, a Hive UDF through the port's C
   library (``auron_register_udf_callback`` answers 0), the geometric-mean
   UDAF over a 4 x 4 file shuffle of pickled states, the bigram UDTF. A
   warm-up per class, then timed runs, each equal to its oracle with its
   K1 and K3 launches checked (K1 24 q93, 36 q72, 8 q5; K3 as
   ``sort_plan`` lists for the UDF class's q42 sort); walls, shuffle bytes
   against the codec-free runs, ``compress_time``, ``decode_time``,
   ``push_time``, the codec and arrow column counts, spill counts, the
   host callbacks' seconds and the device reads are printed; the phase
   fails if no codec plane was written or a codec was unavailable;
23. the SQL front end (``auron_tpu_torch/sql/``, ``models/sqlgate.py``):
   the gate's catalog tables built from the phases' data (the fact widened
   to the 19 columns the TPC-DS texts read, seven more dimensions; timed)
   and their pandas frames for the oracles; the 11 unsupported texts each
   raise SqlUnsupported with the reference's construct and a line >= 1;
   each of the 24 corpus texts (15 verbatim dsdgen store-channel texts, 9
   adaptations) compiled to plan IR, its plan text equal to the reference's
   golden (``tests/goldens/sql/<name>.txt``), a warm-up on the card while
   the pandas oracles run in threads (ORACLE_THREADS), then, with every
   oracle done, a timed run: the distributed stage through the planned-exchange
   driver at P = ``sql.shuffle.partitions`` = 2 and the collect task from
   TaskDefinition bytes; every answer equal to its oracle, K2 once per
   source shard of every exchange (21 plans hold one), the bitonic
   launches as ``sort_plan`` lists for the warm-up's kernel sorts, which go
   through the plain network on the card once more, bit for bit. One line
   a query: compile, engine and oracle seconds, rows, shuffle bytes (rows
   routed times their width), peak device memory, K1-K4 launches;
24. serving (``auron_tpu_torch/serve/``, ``obs/``, ``utils/httpsvc.py``,
   ``models/servegate.py``): a ``SqlServer`` on the card at P = 2 with the
   reference's admission defaults (4 queries at once, each on a CUDA
   stream of its own) over phase 23's tables, and the HTTP service on a
   loopback port. The concurrency gate's three legs over the 24 texts:
   warm, serial replay, 8 clients at rotated offsets on 4 slots (the
   reference's default); every warm answer equal to phase 23's oracle,
   every later answer bit-identical to the warm one, no graph capture or
   kernel build in legs 2-3, a distinct trace id per query, each query's
   K1-K4 launches in the serial leg equal to phase 23's timed run, the
   concurrent leg's total the clients times the serial pass's, and
   concurrent/serial queries/s at least ``SERVE_MIN_SPEEDUP`` (1.0; the
   ratio printed beside the reference's 2.0). In the whole script the
   phase runs last in the second process, once the first has ended its
   phases, so that both legs are timed with nothing else on the host.
   Each timed leg's CPU over wall, host syncs by site, settles, lock
   waits and spills are printed (``servegate`` ``legs``). Then over one
   keep-alive connection POST /sql of q3, q46 and q65 (rows equal to the
   served answers) and of q53 and a denied conf key (400 each), while a
   client serves queries: /healthz, /metrics, /metrics.prom, /trace?last=5,
   /queries and /serve answer 200 with parseable bodies. Under
   ``--serve-only``, then two serial corpus passes with ``obs.mode`` off
   and two with the recorder, alternating (walls printed, no gate; the
   whole script leaves them out to keep inside its time limit), and the
   24 texts once serially and once over the 8 clients under torch.profiler
   (device busy as the union of the streams' device events, the idle
   share). Printed: each leg's seconds,
   queries/s, p50 and p99, the concurrent/serial ratio beside the
   reference's 2.0, admission and plan-cache stats, the engine counters,
   peak device memory, the launches and the trace events recorded.
   ``--serve-only`` builds the tables, frames, oracles and phase 23's
   per-query launches (one warm-up and one timed run each) itself;
25. streaming (``exec/streaming.py``, ``exec/kafka_wire.py``, ``stream/``,
   ``StreamTaskRuntime``, ``serve/streams.py``, ``POST /stream``,
   ``models/streamgate.py``, ``models/kafka_exchange.py``) on the card:
   (a) the JSON deserializer's columnar read equal to its record loop on
   ``streamgate.ingest_edge_polls`` under each error policy and on the
   gate's corpus (every poll of which it reads columnar), then the stream
   gate at the reference's defaults (60,000 events, 3 reps, poll 512, the
   floor 1.05; 1,000,000 events under ``--stream-only``): fused/eager
   events/s at least 1.05 (a failed gate fails the script), fused and
   eager emissions and the crash-resumed log bit-identical, no graph
   capture or kernel build in the timed fused reps, every emission equal
   to the numpy oracle of the view (keys, bounds and counts exact, floats
   at rel 1e-9), each timed rep stepping both legs in turns of eight
   steps after a warm-up run of each; after the gate, each leg's step taken apart and printed
   (``tools/stream_diag.py``: poll, deserialize, upload, the chain by host
   clock and CUDA events, the host read, the window fold, emission). In
   the whole script (a) runs in the second process once the first has
   ended its phases, before phase 24, so that its legs are timed with the
   host to themselves; (b) a ``StreamServer`` with two topics and two
   views (the gate's and a 2 s / 1 s HOP view) registered through POST
   /stream on a loopback port, inspected while they run, the 429 at
   ``stream.serve.max.streams``, cancelled with drain: each stream's
   emissions bit-identical to its view run alone, each under its own
   ``stream.<view>`` trace in /queries; (c) planned ``kafka_scan`` tasks
   with a keyed exchange: 1,000,000 JSON events (4,000,000 under
   ``--stream-only``) of 200,000 users in 2 topic partitions, a map task
   per partition (filter, project, partial aggregate, hash shuffle on the
   user) and 4 reduce tasks (final aggregate, SortExec by total DESC, user
   ASC), every task from bytes: a warm-up (its kernel sorts held against
   the plain network on the card, bit for bit), then a timed run equal to
   the pandas group-by (counts exact, totals at rel 1e-9, order exact),
   the ``kafka_offset_p*`` metrics the topic's ends, K1 once a map task
   (the partial aggregate hands the writer one batch), K3/K4 as
   ``sort_plan`` lists; walls, micro-batches, deserialize seconds,
   shuffle bytes and launches printed;
26. multi-process SPMD (``parallel/multihost.py``, ``MeshQueryDriver(spmd=
   True)``, the cross-process exchange, ``sharded_agg_exchange_step``): the
   one-process runs on the card first, then two worker processes (this
   script with ``--spmd-worker``, the kernels already built) on the
   card over a gloo data plane (NCCL refuses two ranks on one card), each
   owning 2 of P = 4 partitions, reading the fact table from the phase's
   files: (a) q93-mesh on the file transport (a warm-up and a timed run),
   then on the mesh transport (one run, no warm-up: the file runs already
   ran its map stage and loaded the kernels), AQE coalescing off on both
   sides (SPMD cannot regroup partitions), the union of the ranks' answer
   pieces equal to the one-process run bit for bit and to the oracle, K1
   and K2 launched once a local shard in each worker; (b) the reference's SPMD
   STRING group-by over 23.04 M rows whose shards code into different
   subsets of the vocabulary, equal bit for bit and to the numpy oracle;
   (c) ``sharded_agg_exchange_step`` on [2, 2^22] rows a rank against the
   one-process step on [4, 2^22] (sha256 of every output block); then (d)
   rank 0 runs ``all_to_all_rows`` through a world-1 NCCL group of its own
   over [4, 2^22] rows of four columns, bit for bit the one-process
   relayout, overflow included. Every worker wait has a
   timeout. Per leg and rank: map_s, exchange_s, reduce_s,
   K1/K2 launches, peak device memory, beside the one-process walls;
27. the reference's class gate: ``tpcds.run_gate(sf=0.05, device="cuda")``,
   its 42 cases in the reference's order, each class with the reference
   function's task counts, every task from its ``TaskDefinition`` bytes,
   against its oracle (``compare_frames``, floats at rel 1e-6); each
   record printed; fails unless all 42 pass (in the first process, after
   phase 17);
28. print the kernel table as one JSON line (each kernel's launches summed
   over the timed runs of phases 4-26 in both processes, and per run),
   then the status line.

Each phase prints its seconds.

The whole script runs in two processes on the one card, to end inside its
time limit: once the kernels are built and timed, a second process (this
script with ``--late-phases``) makes the data from the same seed and runs
phases 18-23, 25 (b, c), 26, 14 and 16 while this one runs phases 3-13,
15, 17 and 27; then this one writes ``parent.idle`` into the second
process's work directory and waits, and the second process runs phase 25
(a) and phase 24 (so that the stream gate's fused and eager legs and the
serving gate's serial and concurrent legs are timed with nothing else on
the host) and ends. This one then prints the second process's output,
takes its results (``late.pkl`` in its work directory) and goes on with
phase 28.
The second process's session is killed if this one fails, and it ends
itself when this one ends. The walls of phases 3-26 but 24 and 25 (a)
in the whole script are therefore taken with the other process on the
card and the host; the kernel timing, phases 24 and 25 (a) and the
``--*-only`` runs take theirs alone.

Every launch count is set to 0 just before the timed run of a query and
read just after it; launches made to compare kernels are not counted. A
kernel launched inside a captured CUDA graph (K1 in a fused writer stage)
counts once per replay (``plan/fusion.py``: each graph keeps the launches
its capture recorded and adds them at every replay).

Needs no network and no protobuf (phases 18 and 19 fail if
google.protobuf was loaded, 19 also if pyarrow was); the file shuffles'
default lz4 codec (phases 5, 8, 10, 12, 20, 21 and 22) is pyarrow's
``pa.Codec``, phase 20 needs pyarrow (with ``pyarrow.orc``), phase 21
pyarrow for its read-back, phases 23 and 24 pandas for their oracles and
pyarrow for the answers' frames; phases 18 and 19 run with the codec off and
pyarrow blocked; imports nothing of the JAX package. Exits with
code 2 when no CUDA device is visible.
Detailed results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM fp32 non-tensor peak (no int32 row in the table)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
#: oracles of earlier phases, by class, that the spill phase reuses
ORACLES: dict = {}


def _oracle(name: str, data):
    """``tpcds.<name>_class_oracle(data)``, computed once a run: the q42,
    q93, q3, q33 and the A/B classes' oracles serve several phases."""
    if name not in ORACLES:
        from auron_tpu_torch.models import tpcds

        ORACLES[name] = getattr(tpcds, f"{name}_class_oracle")(data)
    return ORACLES[name]


#: threads computing host oracles: one a core, up to 8 (numpy and pandas
#: release the interpreter lock in their sorts, gathers and reductions)
ORACLE_THREADS = max(4, min(8, os.cpu_count() or 4))


def _oracles(fns: dict) -> dict:
    """{name: fn()} with the host oracles computed in threads, before any
    timed run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, min(ORACLE_THREADS, len(fns)))) as pool:
        futures = {name: pool.submit(fn) for name, fn in fns.items()}
        return {name: f.result() for name, f in futures.items()}


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _planes(rng, NP: int, P: int):
    """(NP, P) uint32 planes as int64 carriers: tie-heavy leading planes,
    full-range middle planes, a distinct payload (iota) as the last plane."""
    import numpy as np

    out = np.empty((NP, P), dtype=np.int64)
    for p in range(NP - 1):
        hi = 4 if p == 0 else (1 << 32)
        out[p] = rng.integers(0, hi, P, dtype=np.int64)
    out[NP - 1] = np.arange(P, dtype=np.int64)
    return out


def _lexsorted(planes):
    import numpy as np

    return planes[:, np.lexsort(tuple(planes[::-1]))]


def _bitonic_input(planes):
    """First half ascending, second half descending: one bitonic sequence."""
    import numpy as np

    half = planes.shape[1] // 2
    a = _lexsorted(planes[:, :half])
    b = _lexsorted(planes[:, half:])[:, ::-1]
    return np.ascontiguousarray(np.concatenate([a, b], axis=1))


#: P of the bitonic sweep: clusters of 2, 4 and 16 CTAs of 512 elements,
#: 16 of 1024, the largest single-cluster sort (16 x 2048), and twice that
#: (one strides launch and a cluster tail)
SWEEP_P = (1024, 2048, 8192, 16384, 32768, 65536)
#: (P, NP) past one cluster, run once each: the multi-stride merge path at
#: 8 and 13 planes (three and two strides a launch), the general kernels
SWEEP_LARGE = ((1 << 20, 8), (1 << 18, 13), (1 << 18, 17))
PATTERNS = ("ties", "equal_lead", "sorted", "reversed")


def _sweep_planes(rng, NP: int, P: int, pattern: str):
    """(NP, P) planes as in ``_planes`` shaped by ``pattern``: 'ties' (every
    key plane in 0..2), 'equal_lead' (one value in the leading plane), or
    random planes already 'sorted' or 'reversed'."""
    import numpy as np

    out = _planes(rng, NP, P)
    out[NP - 1] = rng.permutation(P)
    if pattern == "ties":
        out[: NP - 1] = rng.integers(0, 3, (NP - 1, P))
    elif pattern == "equal_lead":
        out[0] = 7
    elif pattern in ("sorted", "reversed"):
        out = _lexsorted(out)
        if pattern == "reversed":
            out = np.ascontiguousarray(out[:, ::-1])
    return out


def check_kernels(seed: int) -> dict:
    """K3/K4 against the plain network and numpy's lexsort, bit for bit:
    every plane count from 2 to one past the largest register kernel (the
    general kernels) at each of SWEEP_P, the patterns in turn; SWEEP_LARGE
    once each; padded operand lengths (cap = P - 3) through the
    operand-level ``bitonic_sort``."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import bitonic

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    checks = []
    err = {"bitonic_sort": 0, "bitonic_merge": 0}
    saved = dict(bitonic.LAUNCHES)
    cases = [(P, NP, PATTERNS[(NP + i) % len(PATTERNS)])
             for NP in range(2, bitonic._MAX_NP + 2) for i, P in enumerate(SWEEP_P)]
    cases += [(P, NP, "ties") for P, NP in SWEEP_LARGE]
    for P, NP, pattern in cases:
        host = _sweep_planes(rng, NP, P, pattern)
        want = _lexsorted(host)
        x = torch.from_numpy(host).to(dev)
        got_k = bitonic._run(x, P, "pallas", merge=False)
        got_p = bitonic._network(x, P)
        err["bitonic_sort"] = max(err["bitonic_sort"], int((got_k - got_p).abs().max()))
        assert np.array_equal(got_k.cpu().numpy(), want), ("bitonic_sort", P, NP, pattern)
        assert torch.equal(got_k, got_p), ("bitonic_sort plain", P, NP, pattern)
        xb = torch.from_numpy(_bitonic_input(host)).to(dev)
        mk = bitonic.bitonic_merge(xb, impl="pallas")
        mp = bitonic._merge_network(xb, P)
        err["bitonic_merge"] = max(err["bitonic_merge"], int((mk - mp).abs().max()))
        assert np.array_equal(mk.cpu().numpy(), want), ("bitonic_merge", P, NP, pattern)
        assert torch.equal(mk, mp), ("bitonic_merge plain", P, NP, pattern)
        plan = bitonic.sort_plan(NP, P)
        checks.append({"P": P, "NP": NP, "pattern": pattern, "launches": len(plan.launches),
                       "merge_launches": len(bitonic.sort_plan(NP, P, merge=True).launches),
                       "sort_equal": True, "merge_equal": True})
    for NP in range(2, bitonic._MAX_NP + 2):
        print(f"kernel check NP={NP}: sort and merge bit-equal to plain and numpy at P "
              f"{SWEEP_P} ({'register' if bitonic.sort_plan(NP, 1024).registers else 'general'}"
              f" kernels)", flush=True)
    for P, NP in SWEEP_LARGE:
        plan = bitonic.sort_plan(NP, P)
        print(f"kernel check P={P} NP={NP}: sort ({len(plan.launches)} launches) and merge "
              f"({len(bitonic.sort_plan(NP, P, merge=True).launches)} launches) bit-equal to "
              f"plain and numpy", flush=True)
    # padded operand lengths: int32 operands of cap = P - 3 rows, -1 padding
    for NP in (2, 8, 11, 16, 17):
        for P in SWEEP_P:
            cap = P - 3
            ops = tuple(torch.from_numpy(rng.integers(-3, 3, cap).astype(np.int32)).to(dev)
                        for _ in range(NP - 1)) + (torch.arange(cap, dtype=torch.int32,
                                                                device=dev),)
            got = bitonic.bitonic_sort(ops, impl="pallas")
            ref = bitonic.bitonic_sort(ops, impl="jnp")
            want = bitonic.lex_sorted(ops)
            for g, r, w in zip(got, ref, want):
                assert torch.equal(g, r) and torch.equal(g, w), ("padded operands", NP, P)
        checks.append({"NP": NP, "caps": [P - 3 for P in SWEEP_P], "operands_equal": True})
        print(f"kernel check padded operands NP={NP}: caps {[P - 3 for P in SWEEP_P]} "
              f"bit-equal to plain and lexsort", flush=True)
    # the operand-level entry: mixed word kinds split and joined on the card
    for cap in (10_000, (1 << 20) - 3):
        live = torch.from_numpy((rng.random(cap) < 0.1).astype(np.int64)).to(dev)
        words = [torch.from_numpy(rng.integers(-hi, hi, cap, dtype=np.int64)).to(dev)
                 for hi in (1 << 12, 2**63 - 1)]  # many ties, then full 64-bit words
        narrow = torch.from_numpy(rng.integers(0, 50, cap).astype(np.int64)).to(dev)
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        ops = (live, *words, narrow, iota)
        flags = (True, False, False, True, False)
        got = bitonic.bitonic_sort(ops, impl="pallas", narrow=flags)
        ref = bitonic.bitonic_sort(ops, impl="jnp", narrow=flags)
        want = bitonic.lex_sorted(ops)
        for g, r, w in zip(got, ref, want):
            assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w), (
                "bitonic_sort operands", cap)
        checks.append({"cap": cap, "operands_equal": True})
        print(f"kernel check operands cap={cap}: bit-equal to plain and lexsort", flush=True)
    bitonic.LAUNCHES.update(saved)
    return {"checks": checks, "max_abs_err": err}


_I64_EDGES = (-(2**63), 2**63 - 1, 0, -1)


def _device_events(prof):
    """(name, device ms, count) of the device-side events of a trace:
    kernels and copies. A host op's device time is the sum of the kernels
    it launched, so summing host ops as well would count them twice."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out.append((e.key, us / 1e3, e.count))
    return out


def _profiled_kernel_ms(fn, name: str, iters: int, attempts: int = 3):
    """Mean device time of the kernels whose name holds ``name``, from
    torch.profiler over ``iters`` calls (a trace that caught none of them
    is taken again, up to ``attempts`` times); None when no trace had any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [(ms, c) for key, ms, c in _device_events(prof) if name in key]
        if hits:
            return sum(ms for ms, _ in hits) / sum(c for _, c in hits)
    return None


def check_partition_kernel(seed: int) -> dict:
    """K1 against its plain version, bit for bit."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 2)
    dev = torch.device("cuda")
    err = 0
    checks = []
    for n in (1, 1000, 1 << 20, (1 << 20) + 37, 5_760_000):
        keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
        keys[: min(n, len(_I64_EDGES))] = _I64_EDGES[: min(n, len(_I64_EDGES))]
        k = torch.from_numpy(keys).to(dev)
        for null_share in (0.85, 0.0):
            valid = torch.from_numpy(rng.random(n) >= null_share).to(dev)
            for n_parts in (1, 3, 4, 200, 4096):
                got = pk.launch_partition_ids(k, valid, n_parts)
                want = pk.plain_partition_ids(k, valid, n_parts)
                torch.cuda.synchronize()
                err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
                assert torch.equal(got, want), ("murmur3_pmod", n, null_share, n_parts)
                assert bool(((got >= 0) & (got < n_parts)).all()), ("pid range", n, n_parts)
            checks.append({"n": n, "null_share": null_share, "equal": True})
        print(f"kernel check murmur3_pmod n={n}: bit-equal to plain for n_parts "
              f"1/3/4/200/4096 at 85 % and 0 % NULL", flush=True)
    return {"checks": checks, "max_abs_err": err}


def time_partition_kernel(seed: int, n: int = 1 << 20, n_parts: int = 4) -> dict:
    """K1 / plain times at the q93 map batch shape (no one library call
    computes Spark murmur3: library_ms is null)."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 3)
    k = torch.from_numpy(rng.integers(1, 100_000, n, dtype=np.int64)).cuda()
    valid = torch.from_numpy(rng.random(n) >= 0.85).cuda()
    saved = dict(pk.LAUNCHES)
    ms = _event_ms(lambda: pk.launch_partition_ids(k, valid, n_parts), 200, warmup=5)
    plain_ms = _event_ms(lambda: pk.plain_partition_ids(k, valid, n_parts), 20, warmup=2)
    device_ms = _profiled_kernel_ms(lambda: pk.launch_partition_ids(k, valid, n_parts),
                                    "murmur3_pmod", 50)
    pk.LAUNCHES.update(saved)
    nbytes = n * (8 + 1 + 4)  # key and validity read once, id written once
    ops = n * 30  # two mix rounds, fmix, pmod, select: ~30 integer ops a row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "n": n, "n_parts": n_parts,
         "device_ms": device_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"murmur3_pmod n={n} n_parts={n_parts}: kernel {ms:.4f} ms a call "
          f"(device time {device_ms} ms a launch, torch.profiler), plain {plain_ms:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), no library call", flush=True)
    return r


_I32_EDGES = (-1, -(2**31), 2**31 - 1)


def check_histogram_kernel(seed: int) -> dict:
    """K2 against its plain version (bit for bit) and numpy's bincount."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 4)
    dev = torch.device("cuda")
    shared_parts = pk.histogram_shared_parts()
    parts = (1, 2, 4, 8, 200, 4096, shared_parts + 1)
    err = 0
    checks = []
    for n in (0, 1, 1000, (1 << 20) + 37, 5_767_168, 23_040_000):
        base = rng.integers(0, 2**31, n, dtype=np.int64)
        shares = rng.random(n)
        for n_parts in parts:
            # ids from -3 to n_parts + 2: some out of range on both sides
            pids = (base % (n_parts + 6) - 3).astype(np.int32)
            edges = np.array(_I32_EDGES + (n_parts,), np.int32)[: min(n, 4)]
            pids[: len(edges)] = edges
            p = torch.from_numpy(pids).to(dev)
            for live_share in (0.0, 0.5, 1.0):
                sel = shares < live_share
                s = torch.from_numpy(sel).to(dev)
                got = pk.launch_partition_histogram(p, n_parts, s)
                want = pk.plain_partition_histogram(p, n_parts, s)
                torch.cuda.synchronize()
                err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
                assert torch.equal(got, want), ("partition_histogram", n, n_parts, live_share)
                keep = sel & (pids >= 0) & (pids < n_parts)
                host = np.bincount(pids[keep], minlength=n_parts)
                assert np.array_equal(got.cpu().numpy(), host), ("bincount", n, n_parts)
            no_sel = pk.launch_partition_histogram(p, n_parts)
            assert torch.equal(no_sel, pk.plain_partition_histogram(p, n_parts)), (
                "partition_histogram without sel", n, n_parts)
        checks.append({"n": n, "n_parts": list(parts), "equal": True})
        print(f"kernel check partition_histogram n={n}: bit-equal to plain and numpy for "
              f"n_parts {parts} at 0/50/100 % live", flush=True)
    return {"checks": checks, "max_abs_err": err, "shared_parts": shared_parts}


def time_histogram_kernel(seed: int, n_parts: int = 4) -> dict:
    """K2 / plain / torch.bincount at one q93 map shard: six fact batches
    concatenated to 8,388,608 rows of capacity, 5,760,000 live, ~89 % of
    the live ids on one partition (the NULL-key skew); the same timings on
    uniform ids beside it."""
    import numpy as np
    import torch

    from auron_tpu_torch.columnar.batch import bucket_capacity
    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 5)
    n = bucket_capacity(5 * (1 << 20) + (1 << 19))
    live = 5_760_000
    sel = torch.zeros(n, dtype=torch.bool, device="cuda")
    sel[:live] = True
    saved = dict(pk.LAUNCHES)
    res = {}
    for shape in ("skewed", "uniform"):
        ids = rng.integers(0, n_parts, n)
        if shape == "skewed":
            ids = np.where(rng.random(n) < 0.89, 42 % n_parts, ids)
        p = torch.from_numpy(ids.astype(np.int32)).cuda()
        blended = torch.where(sel, p.to(torch.int64), n_parts)
        r = {
            "ms": _event_ms(lambda: pk.launch_partition_histogram(p, n_parts, sel), 200,
                            warmup=5),
            "plain_ms": _event_ms(lambda: pk.plain_partition_histogram(p, n_parts, sel), 50),
            # one library call on the blended ids (the blend itself not timed)
            "library_ms": _event_ms(lambda: torch.bincount(blended, minlength=n_parts + 1),
                                    50),
            "device_ms": _profiled_kernel_ms(
                lambda: pk.launch_partition_histogram(p, n_parts, sel), "histogram", 50),
        }
        res[shape] = r
    pk.LAUNCHES.update(saved)
    # every sel byte read once, the id of each live row read once (a dead
    # row's id is not needed), the counts written once
    nbytes = n * 1 + int(sel.sum()) * 4 + n_parts * 4
    ops = n * 4  # range check, sel test, match, add: a few integer ops a row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    out = {**res["skewed"], "uniform": res["uniform"], "n": n, "live": live,
           "n_parts": n_parts, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    for shape, r in res.items():
        print(f"partition_histogram n={n} live={live} n_parts={n_parts} {shape}: kernel "
              f"{r['ms']:.4f} ms a call (device time {r['device_ms']} ms a launch, "
              f"torch.profiler), plain {r['plain_ms']:.4f} ms, torch.bincount "
              f"{r['library_ms']:.4f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']})",
              flush=True)
    return out


def _reset_launches() -> None:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    for counts in (bitonic.LAUNCHES, partition_kernels.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    return {**bitonic.LAUNCHES, **partition_kernels.LAUNCHES}


#: (P, NP) of the sorts timed in phase 3: q42's SortExec (16,384 x 8),
#: q3-mesh's collect sort on the mesh (16,384 x 11) and file (8,192 x 11)
#: transports, 2^20 x 8, past one cluster (the multi-stride merge path),
#: q72's probe-side SortExec under elision mode build (2^23 x 8 and
#: 2^24 x 8: the reader's batches of ~5.76 M rows concatenate to either),
#: q17's two probe-side SortExecs at SF 8 (2^25 x 5: 23.04 M rows on one
#: int64 key each, live + null + two value planes + payload), and the
#: collect sorts of sql q34 (32,768 x 17) and q46 (262,144 x 17): past the
#: register kernels' 16 planes, so the general local and global kernels
SORT_SHAPES = ((16384, 8), (16384, 11), (8192, 11), (1 << 20, 8), (1 << 23, 8), (1 << 24, 8),
               (1 << 25, 5), (32768, 17), (262144, 17))


def _kernel_name(name: str) -> str:
    """'bitonic_cluster<8, 8>' out of a demangled kernel signature."""
    import re

    m = re.search(r"(bitonic_\w+(?:<[^>]*>)?)", name)
    return m.group(1) if m else name


def _profiled_launches(fn, iters: int, attempts: int = 3):
    """The device launches of one call of ``fn`` in order, as [name, mean
    device ms] pairs, from torch.profiler over ``iters`` calls (each call
    must launch the same sequence of bitonic kernels); None when no trace
    caught them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e.time_range.start, _kernel_name(e.name), e.time_range.elapsed_us())
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and "bitonic" in e.name)
        if evs and len(evs) % iters == 0:
            n = len(evs) // iters
            return [[evs[i][1], sum(evs[c * n + i][2] for c in range(iters)) / iters / 1e3]
                    for i in range(n)]
    return None


def _by_kernel(seq) -> dict:
    """Device ms and launches per kernel of one call's launch sequence; the
    first launch is keyed apart (the tile or cluster sort of a sort call)."""
    out: dict = {}
    for i, (name, ms) in enumerate(seq or ()):
        key = f"{name} (first launch)" if i == 0 else name
        r = out.setdefault(key, {"ms": 0.0, "launches": 0})
        r["ms"] += ms
        r["launches"] += 1
    return out


def _sort_bound(NP: int, P: int, compare_exchanges: int) -> dict:
    nbytes = 2 * NP * P * 4  # each plane read once and written once
    ops = 3 * NP * compare_exchanges  # compare, equality chain, select per plane
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_kernels(seed: int) -> dict:
    """K3 (a whole sort, ``kernel_sort_``) and K4 (the merge of one bitonic
    sequence, ``kernel_merge_``) at each of SORT_SHAPES: the call time by
    CUDA events, the device time of every launch by torch.profiler (so
    launches per call and the whole call's device time), the launches the
    wrappers counted, the plain network's and the library lexsort's times.
    The q42 shape's figures head the result (the kernel table's row)."""
    import math

    import numpy as np
    import torch

    from auron_tpu_torch.ops import bitonic
    from auron_tpu_torch.ops.uwords import i32_of_u32

    rng = np.random.default_rng(seed + 1)
    dev = torch.device("cuda")
    saved = dict(bitonic.LAUNCHES)
    shapes = []
    for P, NP in SORT_SHAPES:
        host = _planes(rng, NP, P)
        x = torch.from_numpy(host).to(dev)
        x32 = i32_of_u32(x).contiguous()
        kinds = ("i64",) * NP
        # the sorted planes from the library lexsort on the card (numpy's
        # takes seconds at 2^23)
        sorted32 = i32_of_u32(torch.stack(bitonic.lex_sorted(tuple(x), kinds))).contiguous()
        L = int(math.log2(P))
        small = P <= 16384
        bit = torch.from_numpy(_bitonic_input(host)).to(dev) if small else x
        iters = 50 if small else 10
        # sort: the data-oblivious network takes the same time on any input,
        # so re-sorting one buffer is a fair loop; merge: an ascending run is
        # bitonic, so the in-place loop keeps a valid input
        calls = {
            "bitonic_sort": (lambda: bitonic.kernel_sort_(x32), lambda: bitonic._network(x, P),
                             tuple(x[p] for p in range(NP)), (P // 2) * L * (L + 1) // 2),
            "bitonic_merge": (lambda: bitonic.kernel_merge_(sorted32),
                              lambda: bitonic._merge_network(bit, P),
                              tuple(bit[p] for p in range(NP)), (P // 2) * L),
        }
        shape = {"P": P, "NP": NP}
        for name, (kernel, plain, cols, cx) in calls.items():
            before = dict(bitonic.LAUNCHES)
            kernel()
            torch.cuda.synchronize()
            counted = {k: bitonic.LAUNCHES[k] - before[k] for k in before}
            seq = _profiled_launches(kernel, iters)
            r = {
                "ms": _event_ms(kernel, iters),
                "device_ms": sum(ms for _, ms in seq) if seq else None,
                "launches": len(seq) if seq else None,
                "counted_launches": counted,
                "by_kernel": _by_kernel(seq),
                "sequence": seq,
                "plain_ms": _event_ms(plain, 5, warmup=1) if small else None,
                "library_ms": _event_ms(lambda: bitonic.lexsort(cols, kinds), iters),
                "compare_exchanges": cx,
                **_sort_bound(NP, P, cx),
            }
            shape[name] = r
            kern = "; ".join(f"{k} {v['ms']:.5f} ms x{v['launches']}"
                             for k, v in r["by_kernel"].items())
            plain_s = f"{r['plain_ms']:.4f} ms" if r["plain_ms"] is not None else "not timed"
            print(f"{name} P={P} NP={NP}: a call {r['ms']:.4f} ms (CUDA events), device "
                  f"{r['device_ms']} ms in {r['launches']} launches (torch.profiler: {kern}), "
                  f"wrapper counts {counted}, plain {plain_s}, torch.sort lexsort "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})",
                  flush=True)
        shapes.append(shape)
    bitonic.LAUNCHES.update(saved)
    return {"bitonic_sort": shapes[0]["bitonic_sort"], "bitonic_merge": shapes[0]["bitonic_merge"],
            "sort_shapes": shapes}


def time_cluster_sizes(seed: int) -> list:
    """Device time of one ``bitonic_cluster`` launch that sorts (and one
    that merges) each main-path shape, at every cluster size from 2 to 16
    CTAs that the tile limits allow: the measurement behind sort_plan's
    choice of cluster and tile."""
    import ctypes

    import numpy as np
    import torch

    from auron_tpu_torch.ops import bitonic
    from auron_tpu_torch.ops.uwords import i32_of_u32

    lib = bitonic._lib()
    rng = np.random.default_rng(seed + 6)
    out = []
    for P, NP in SORT_SHAPES[:3]:
        host = _sweep_planes(rng, NP, P, "ties")
        want = _lexsorted(host)
        for C in (2, 4, 8, 16):
            T = P // C
            if not 32 * bitonic._PER_THREAD <= T <= bitonic._TILE:
                continue
            clusters = lib.auron_bitonic_prepare(NP, T, C, bitonic._PER_THREAD)
            assert clusters > 0, (P, NP, C, clusters)
            x32 = i32_of_u32(torch.from_numpy(host).cuda()).contiguous()
            r = {"P": P, "NP": NP, "cluster": C, "tile": T, "max_active_clusters": clusters}
            for mode, k_lo in (("sort", 2), ("merge", P)):
                desc = (ctypes.c_longlong * 4)(0, k_lo, P, 0)

                def run(desc=desc, x32=x32, T=T, C=C):
                    bitonic._check(lib.auron_bitonic_run(
                        ctypes.c_void_p(x32.data_ptr()), NP, P, T, C, bitonic._PER_THREAD, desc,
                        1, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))

                run()
                torch.cuda.synchronize()
                if mode == "sort":
                    got = x32.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
                    assert np.array_equal(got, want), ("cluster size", P, NP, C)
                seq = _profiled_launches(run, 20)
                r[f"{mode}_device_ms"] = sum(ms for _, ms in seq) if seq else None
            out.append(r)
            print(f"one cluster launch P={P} NP={NP}: {C} CTAs x {T} elements "
                  f"({clusters} such clusters fit the card): sort {r['sort_device_ms']} ms, "
                  f"merge {r['merge_device_ms']} ms of device time", flush=True)
    return out


def time_sorts_main() -> int:
    """``chip_smoke.py --time-sorts``: the card, the build, and phase 3's
    bitonic timings only, as one JSON line (a yardstick to run on two trees
    in one call); prints no status line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    clock = [time.perf_counter()]
    from auron_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_build.build_all()
    for name, log in cuda_build.BUILD_LOG.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    from auron_tpu_torch.ops import bitonic

    out = time_kernels(42)
    # a tree without sort_plan has no cluster kernel to size
    sizes = time_cluster_sizes(42) if hasattr(bitonic, "sort_plan") else None
    print(json.dumps({"nvidia_smi": smi, "sort_shapes": out["sort_shapes"],
                      "cluster_sizes": sizes}), flush=True)
    return 0


def run_q42(data, sf: float, t_gen: float) -> dict:
    import numpy as np
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    ingested = tpcds.ingest_q42(data, device="cuda")
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    oracle = _oracle("q42", data)
    # warm-up run (first launches, allocator), checked like the timed one;
    # it records the shape of every sort the kernels run
    shapes: list = []
    with _recording_kernel_sorts(shapes):
        warm = tpcds.run_q42_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    got = tpcds.run_q42_class(device="cuda", ingested=ingested, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        assert out["brand"].shape == (10,) and np.isfinite(out["rev"]).all(), out
        assert np.array_equal(out["brand"], oracle["brand"]), (out["brand"], oracle["brand"])
        np.testing.assert_allclose(out["rev"], oracle["rev"], rtol=1e-9, atol=0)
    _assert_planned_launches("q42", shapes, launches)
    sort_ms = {k: v * 1e3 for k, v in stats["timers"].items() if k.endswith("sort_time")}
    rows = data.fact_rows()
    print(f"q42-class SF {sf}: {rows} fact rows, wall {wall:.4f} s, "
          f"{rows / wall:.1f} fact rows/s, sorts (P, NP) {[s[::-1] for s in shapes]}, "
          f"launches {launches}, host sort timer {sort_ms} ms, top brand "
          f"{int(got['brand'][0])} rev {float(got['rev'][0]):.2f}, {_from_bytes(stats)}",
          flush=True)
    return {"sf": sf, "fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
            "generate_s": t_gen, "ingest_s": t_ingest, "launches": launches,
            "sort_shapes": shapes, "sort_time_ms": sort_ms,
            "brand": got["brand"].tolist(), "rev": got["rev"].tolist()}, ingested


@contextlib.contextmanager
def _recording_kernel_sorts(shapes: list):
    """Record the (NP, P) of every sort ``bitonic.kernel_sort_`` runs inside
    the block, and (NP, P, True) of every merge ``bitonic.kernel_merge_``
    runs (the merges of a SortExec's spilled runs): ``sort_plan(*shape)``
    lists either's launches."""
    from auron_tpu_torch.ops import bitonic

    real_sort, real_merge = bitonic.kernel_sort_, bitonic.kernel_merge_

    def sorting(x32):
        shapes.append(tuple(x32.shape))
        return real_sort(x32)

    def merging(x32):
        shapes.append((*x32.shape, True))
        return real_merge(x32)

    bitonic.kernel_sort_, bitonic.kernel_merge_ = sorting, merging
    try:
        yield
    finally:
        bitonic.kernel_sort_, bitonic.kernel_merge_ = real_sort, real_merge


def _assert_planned_launches(label: str, shapes: list, launches: dict,
                             sorts: bool = True) -> None:
    """The bitonic launches of a timed run equal what ``sort_plan`` lists
    for the sorts and run merges its warm-up recorded, and there was a
    sort (none when ``sorts`` is False)."""
    from auron_tpu_torch.ops import bitonic

    assert bool(shapes) == sorts, f"{label}: kernel sorts {shapes}, expected any: {sorts}"
    planned = {k: sum(bitonic.sort_plan(*s).launch_counts()[k] for s in shapes)
               for k in bitonic.LAUNCHES}
    got = {k: launches[k] for k in bitonic.LAUNCHES}
    assert got == planned, f"{label}: bitonic launches {got}, sort_plan lists {planned}"


def _print_timers(query: str, stats: dict) -> None:
    for k, v in sorted(stats["timers"].items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {query} host timer {v * 1e3:9.3f} ms  {k}", flush=True)


def _from_bytes(stats: dict) -> str:
    """A run's tasks from ``TaskDefinition`` bytes, summed over its tasks
    (and over the paths of a run whose stats hold one dict a path): bytes,
    decode and planning seconds. Fails if no task of the run started from
    bytes."""
    parts = [stats] + [v for v in stats.values() if isinstance(v, dict) and "task_bytes" in v]
    tb, dec, pln = (sum(s.get(k, 0) for s in parts) for k in ("task_bytes", "decode_s", "plan_s"))
    assert tb > 0, "no task of the run started from TaskDefinition bytes"
    return f"task_bytes {tb:,}, decode_s {dec * 1e3:.3f} ms, plan_s {pln * 1e3:.3f} ms"


def _is_cub_sort(kernel: str) -> bool:
    k = kernel.lower()
    return "cub" in k and "sort" in k


def profile_run(query: str, fn) -> dict:
    """One more run under torch.profiler: device busy time (sum of the
    device-side events, one stream) against the wall, and the top kernels.
    Its launches are not counted in the kernel table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    saved = _launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from auron_tpu_torch.ops import bitonic, partition_kernels

    for counts in (bitonic.LAUNCHES, partition_kernels.LAUNCHES):
        counts.update({k: saved[k] for k in counts})
    kernels = sorted(_device_events(prof), key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
           "top_kernels": [{"name": n, "ms": ms, "count": c} for n, ms, c in kernels[:12]],
           "cub_sorts": {"calls": sum(c for n, _, c in kernels if _is_cub_sort(n)),
                         "ms": sum(ms for n, ms, _ in kernels if _is_cub_sort(n))}}
    print(f"{query} profile: wall {out['wall_ms']:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {out['device_idle_share']:.3f}", flush=True)
    for n, ms, c in kernels[:8]:
        print(f"  kernel {ms:9.4f} ms x{c:5d}  {n[:100]}", flush=True)
    return out


def run_q93(data, fact) -> dict:
    """q93-class, 4 map x 4 reduce: warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_q93(data, 4, device="cuda", fact=fact)
    oracle = _oracle("q93", data)
    warm = tpcds.run_q93_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    got = tpcds.run_q93_class(device="cuda", ingested=ingested, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        _assert_q93(out, oracle)
    assert launches["murmur3_pmod"] > 0, f"q93 main path launched K1 no time: {launches}"
    ORACLES["q93"] = oracle
    null_rows = stats["partition_rows"][stats["null_partition"]]
    rows = data.fact_rows()
    print(f"q93-class: {rows} fact rows, wall {wall:.4f} s (map stage {stats['map_s']:.4f} s, "
          f"reduce stage {stats['reduce_s']:.4f} s), shuffle bytes written "
          f"{stats['shuffle_bytes']}, NULL-key partition {stats['null_partition']} got "
          f"{null_rows} rows of {sum(stats['partition_rows'])}, launches {launches}, "
          f"{_from_bytes(stats)}", flush=True)
    _print_timers("q93", stats)
    return {"fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall, **stats,
            "null_partition_rows": null_rows, "launches": launches,
            "rows": got["rows"].tolist(), "matched": got["matched"].tolist(),
            "s": got["s"].tolist()}


def run_q3(data, fact) -> dict:
    """q3-class, 4 map x 4 reduce: warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_q3(data, 4, device="cuda", fact=fact)
    oracle = _oracle("q3", data)
    warm = tpcds.run_q3_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    got = tpcds.run_q3_class(device="cuda", ingested=ingested, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        _assert_q3(out, oracle)
    rows = data.fact_rows()
    print(f"q3-class: {rows} fact rows, wall {wall:.4f} s (map stage {stats['map_s']:.4f} s, "
          f"reduce stage {stats['reduce_s']:.4f} s), shuffle bytes written "
          f"{stats['shuffle_bytes']}, launches {launches}, first row "
          f"({int(got['d_year'][0])}, {int(got['i_brand_id'][0])}, {float(got['s'][0]):.2f}), "
          f"{_from_bytes(stats)}", flush=True)
    _print_timers("q3", stats)
    return {"fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall, **stats,
            "launches": launches, "top": {k: v[:10].tolist() for k, v in got.items()}}


def _assert_q93(out: dict, want: dict) -> None:
    assert out["k_null"].tolist() == want["k_null"].tolist(), (out, want)
    for k in ("rows", "matched"):
        assert _np_equal(out[k], want[k]), (k, out, want)
    assert all(math.isfinite(x) for x in out["s"])
    _assert_close(out["s"], want["s"])


def _assert_q3(out: dict, want: dict) -> None:
    assert len(out["s"]) == len(want["s"]) > 0 and all(math.isfinite(x) for x in out["s"])
    for k in ("d_year", "i_brand_id"):
        assert _np_equal(out[k], want[k]), (k, out[k][:10], want[k][:10])
    _assert_close(out["s"], want["s"])


def _np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(a, b))


def _assert_close(got, want) -> None:
    import numpy as np

    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@contextlib.contextmanager
def _recording_sorts(record: list):
    """Record a copy of the operands of every kernel sort
    (``bitonic.bitonic_sort`` with ``impl="pallas"`` on the card: the
    ``SortExec`` sorts through ``ordered_sort`` and the full-word grouping
    sorts of an aggregate) and of every merge of two sorted runs' planes
    (``bitonic.merge_sorted_planes`` on the card: a SortExec's spilled runs)
    made inside the block."""
    from auron_tpu_torch.ops import bitonic

    real_sort, real_merge = bitonic.bitonic_sort, bitonic.merge_sorted_planes

    def sorting(operands, *, impl="jnp", narrow=None, kinds=None):
        if impl == "pallas" and operands[0].is_cuda:
            record.append(("sort", tuple(o.clone() for o in operands), narrow, kinds))
        return real_sort(operands, impl=impl, narrow=narrow, kinds=kinds)

    def merging(a, b):
        if a.is_cuda:
            record.append(("merge", a.clone(), b.clone()))
        return real_merge(a, b)

    bitonic.bitonic_sort, bitonic.merge_sorted_planes = sorting, merging
    try:
        yield
    finally:
        bitonic.bitonic_sort, bitonic.merge_sorted_planes = real_sort, real_merge


def _check_merge(label: str, a, b) -> dict:
    """One recorded run merge once more: K4 (``merge_sorted_planes`` on the
    int32 planes) against the plain network over the same bitonic sequence
    on the card, bit for bit, and against the library lexsort."""
    import torch

    from auron_tpu_torch.ops import bitonic
    from auron_tpu_torch.ops.uwords import MASK32, u32_of_i32

    NP, n = a.shape[0], a.shape[1] + b.shape[1]
    P = max(bitonic._next_pow2(n), 8 * bitonic._LANES)
    before = dict(bitonic.LAUNCHES)
    got = u32_of_i32(bitonic.merge_sorted_planes(a, b))
    launched = {k: bitonic.LAUNCHES[k] - before[k] for k in before}
    x = torch.full((NP, P), MASK32, dtype=torch.int64, device=a.device)
    x[:, :a.shape[1]] = u32_of_i32(a)
    x[:, P - b.shape[1]:] = u32_of_i32(b).flip(1)
    ref = bitonic._merge_network(x, P)[:, :n]
    cat = torch.cat([u32_of_i32(a), u32_of_i32(b)], dim=1)
    want = torch.stack(bitonic.lex_sorted(tuple(cat), ("u32",) * NP))
    assert torch.equal(got, ref) and torch.equal(got, want), ("main-path merge", label)
    err = int((got - ref).abs().max())
    shape = {"merge": True, "n": n, "P": P, "NP": NP, "launches": launched, "max_abs_err": err}
    assert launched == bitonic.sort_plan(NP, P, merge=True).launch_counts(), (label, shape)
    print(f"kernel check {label} run merge: {a.shape[1]} + {b.shape[1]} rows, P {P}, NP {NP}, "
          f"kernel launches {launched}: bit-equal to plain and lexsort", flush=True)
    return shape


def check_sorts(label: str, record: list) -> list:
    """K3/K4 at a main path's own sort shapes: each recorded operand tuple,
    sorted by the CUDA kernels and by the plain network on the card, bit
    for bit, and against the library lexsort; each recorded run merge
    likewise (``_check_merge``). Its launches are not counted."""
    import torch

    from auron_tpu_torch.ops import bitonic

    saved = dict(bitonic.LAUNCHES)
    out = []
    for kind, *entry in record:
        if kind == "merge":
            out.append(_check_merge(label, *entry))
            continue
        ops, narrow, kinds = entry
        narrow = narrow if narrow is not None else (False,) * len(ops)
        kinds = kinds if kinds is not None else tuple(bitonic._default_kind(o) for o in ops)
        before = dict(bitonic.LAUNCHES)
        got = bitonic.bitonic_sort(ops, impl="pallas", narrow=narrow, kinds=kinds)
        launched = {k: bitonic.LAUNCHES[k] - before[k] for k in before}
        cap = ops[0].shape[0]
        NP = len(bitonic._split_planes32(ops, narrow, kinds))
        P = max(bitonic._next_pow2(cap), 8 * bitonic._LANES)
        ref = bitonic.bitonic_sort(ops, impl="jnp", narrow=narrow, kinds=kinds)
        want = bitonic.lex_sorted(ops, kinds)
        err = 0
        for g, r, w in zip(got, ref, want):
            assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w), (
                "main-path sort", label)
            err = max(err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
        del got, ref, want
        shape = {"cap": cap, "P": P, "NP": NP, "launches": launched, "max_abs_err": err}
        assert launched == bitonic.sort_plan(NP, P).launch_counts(), (label, shape)
        out.append(shape)
        print(f"kernel check {label} sort: cap {cap}, P {shape['P']}, NP "
              f"{shape['NP']}, kernel launches {launched}: bit-equal to plain and lexsort",
              flush=True)
    bitonic.LAUNCHES.update(saved)
    return out


def run_mesh(query: str, data, fact, n_parts: int = 4) -> dict:
    """q93-mesh or q3-mesh through the planned-exchange driver, once per
    transport (mesh, then file): warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    if query == "q93":
        ingested = tpcds.ingest_q93(data, n_parts, device="cuda", fact=fact)
        run, oracle, check = tpcds.run_q93_mesh, _oracle("q93", data), _assert_q93
    else:
        ingested = tpcds.ingest_q3(data, n_parts, device="cuda", fact=fact)
        run, oracle, check = tpcds.run_q3_mesh, _oracle("q3", data), _assert_q3
    out = {}
    answers = {}
    for mode in ("mesh", "file"):
        conf = {"exchange.mode": mode}
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(n_parts=n_parts, device="cuda", conf=conf, ingested=ingested)
        sort_checks = check_sorts(f"{query}-mesh ({mode})", sorts)
        _reset_launches()
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        got = run(n_parts=n_parts, device="cuda", conf=conf, stats=stats, ingested=ingested)
        wall = time.perf_counter() - t0
        launches = _launches()
        for ans in (warm, got):
            check(ans, oracle)
        assert stats["mode"] == mode, stats
        assert launches["partition_histogram"] == n_parts, (
            f"{query}-mesh ({mode}) launched K2 {launches['partition_histogram']} times, "
            f"not once per source shard ({n_parts}): {launches}")
        if query == "q93":
            assert launches["murmur3_pmod"] > 0, f"q93-mesh ({mode}) launched K1 no time"
        answers[mode] = got
        rows = data.fact_rows()
        print(f"{query}-mesh exchange.mode={mode}: {rows} fact rows, P={n_parts}, wall "
              f"{wall:.4f} s (map {stats['map_s']:.4f} s, exchange {stats['exchange_s']:.4f} s, "
              f"reduce {stats['reduce_s']:.4f} s"
              + (f", collect {stats['collect_s']:.4f} s" if "collect_s" in stats else "")
              + f"), slot_cap {stats['slot_cap']}, est bytes per shard "
              f"{stats['est_bytes_per_shard']}, coalesced {stats['coalesced_groups']}, peak "
              f"device memory {stats['peak_bytes'] / 2**30:.3f} GiB, launches {launches}",
              flush=True)
        print(f"  {query}-mesh routing matrix [src][dst] (live rows): {stats['routing']}",
              flush=True)
        if query == "q3":
            _assert_planned_launches(f"q3-mesh ({mode})", shapes, launches)
            assert sort_checks, f"q3-mesh ({mode}): no collect sort was recorded"
        out[mode] = {"wall_s": wall, "rows_per_s": rows / wall, **stats, "launches": launches,
                     "sort_shapes": shapes, "sort_checks": sort_checks}
    # the two transports agree with each other
    a, b = answers["mesh"], answers["file"]
    for k in a:
        if k == "s":
            _assert_close(a[k], b[k])
        else:
            assert _np_equal(a[k], b[k]), (query, k)
    return out


#: phase 8: (label, class, task conf, kernels its timed run must launch).
#: q72 shuffles both facts on item, q95 on customer, q65 and q5 their
#: partial aggregates on item: single-INT64-key shuffles, so K1; q18 and
#: q14 shuffle on two keys or one INT32 key (the generic hash, no kernel)
GATE_RUNS = (
    ("q72 (full)", "q72", {"auron.smj.elide.sorts": "full"}, ("murmur3_pmod",)),
    ("q72 (build)", "q72", {"auron.smj.elide.sorts": "build"},
     ("murmur3_pmod", "bitonic_sort", "bitonic_merge")),
    ("q95", "q95", None, ("murmur3_pmod",)),
    ("q18", "q18", None, ()),
    ("q14", "q14", None, ()),
    ("q65", "q65", None, ("murmur3_pmod",)),
    ("q5", "q5", None, ("murmur3_pmod",)),
)
#: answer columns held at rel 1e-9 (float sums and averages); the others exactly
FLOAT_SUMS = ("p_avg", "q_avg", "p_sum", "a", "s", "total", "mean", "cheap_s", "all_s",
              "ratio", "s99", "s98")


def _assert_answer(label: str, got: dict, want: dict, allow_empty: bool = False) -> None:
    """``got`` equals the oracle ``want``; an empty oracle is refused unless
    ``allow_empty`` (then ``got`` must be empty too)."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    n = len(next(iter(want.values())))
    assert n > 0 or allow_empty, (label, "empty oracle")
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        if k in FLOAT_SUMS:
            assert all(math.isfinite(x) for x in g), (label, k)
            _assert_close(g, w)
        else:
            assert _np_equal(g, w), (label, k, g[:10], w[:10])


def _gate_inputs(name: str, data, fact) -> dict:
    from auron_tpu_torch.models import tpcds

    if name == "q72":
        return tpcds.ingest_q72(data, 4, device="cuda", fact=fact)
    if name == "q95":
        return tpcds.ingest_q95(data, 4, device="cuda", fact=fact)
    if name in ("q18", "q14"):
        return tpcds.ingest_q3(data, 4, device="cuda", fact=fact)
    return {"fact": fact}


def _assert_must_launch(label: str, launches: dict, kernels) -> None:
    for k in kernels:
        assert launches[k] > 0, f"{label}: the main path launched {k} no time: {launches}"


def run_gate_classes(data, fact, oracles: dict) -> dict:
    """Phase 8: each of GATE_RUNS, 4 x 4: warm-up (its kernel sorts
    recorded and checked on the card), then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    out = {}
    inputs: dict = {}
    for label, name, conf, must in GATE_RUNS:
        if name not in inputs:
            inputs[name] = _gate_inputs(name, data, fact)
        ingested = inputs[name]
        run = getattr(tpcds, f"run_{name}_class")
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(device="cuda", conf=conf, ingested=ingested)
        sort_checks = check_sorts(label, sorts)
        del sorts
        if sort_checks:  # the checks' large temporaries leave the allocator cold
            torch.cuda.empty_cache()
            run(device="cuda", conf=conf, ingested=ingested)
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        t0 = time.perf_counter()
        got = run(device="cuda", conf=conf, ingested=ingested, stats=stats)
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        for ans in (warm, got):
            _assert_answer(label, ans, oracles[name])
        ORACLES[name] = oracles[name]
        _assert_planned_launches(label, shapes, launches, sorts="bitonic_sort" in must)
        assert len(sort_checks) == len(shapes), (label, len(sort_checks), shapes)
        _assert_must_launch(label, launches, must)
        rows = len(next(iter(got.values())))
        print(f"{label}-class: wall {wall:.4f} s (stages {_fmt_s(stats['stage_s'])}, reduce "
              f"{stats['reduce_s']:.4f} s), shuffle bytes written {stats['shuffle_bytes']}, "
              f"{rows} result rows, kernel sorts (NP, P) {shapes}, launches {launches}, peak "
              f"device memory {peak / 2**30:.3f} GiB, {_from_bytes(stats)}", flush=True)
        _print_timers(label, stats)
        out[label] = {"wall_s": wall, **stats, "launches": launches, "peak_bytes": peak,
                      "result_rows": rows, "sort_shapes": shapes, "sort_checks": sort_checks}
    return out


#: phase 10: the expression-tail and join-tail classes (tpcds.TAIL_CLASSES)
#: with the JAX functions' partition and task counts, as (label, class, task
#: conf, kernels its timed run must launch). q17's two probe-side SortExecs
#: sort 23.04 M rows at 2^25 slots (K3 and K4); q16 file-shuffles on the
#: nullable INT64 customer (K1). A dictionary-keyed aggregate (q17's and
#: q41's group by i_category) segments by a fingerprint sort on a card by
#: default (exec.agg.incremental.fingerprint = auto), which is the library
#: sort; q41 runs a second time with the fingerprint off, so that its
#: full-word grouping sort goes through K3
TAIL_RUNS = (
    ("q17", "q17", None, ("bitonic_sort", "bitonic_merge")),
    ("q16", "q16", None, ("murmur3_pmod",)),
    ("q41", "q41", None, ()),
    ("q41 (fingerprint off)", "q41", {"exec.agg.incremental.fingerprint": "off"},
     ("bitonic_sort",)),
) + tuple((name, name, None, ()) for name in (
    "q48", "q99", "q37", "q6", "q85", "q1", "q88", "q14b", "q2", "q4", "q11", "q15", "q31",
    "q34", "q38", "q54", "q58", "q79", "q22"))
#: the JAX functions' fact partitions (map tasks) per class; 1 otherwise
TAIL_PARTITIONS = {"q1": 4, "q6": 2, "q48": 2, "q16": 2}


def run_tail_classes(data, fact) -> dict:
    """Phase 10: each of TAIL_RUNS at the phases' shared scale: a warm-up
    (its kernel sorts recorded, then sorted once more by K3/K4 and by the
    plain network on the card, bit for bit), then the timed run, whose
    bitonic launches must equal ``sort_plan``'s for the recorded sorts.
    Every answer equals its numpy oracle; a class whose oracle is empty at
    this scale (no customer with 3 to 5 sales, no item never sold cheap)
    must be empty too."""
    import torch

    from auron_tpu_torch.models import tpcds

    assert {name for _, name, _, _ in TAIL_RUNS} == set(tpcds.TAIL_CLASSES)
    t0 = time.perf_counter()
    inputs = {n: tpcds.ingest_q3(data, n, device="cuda", fact=fact if n == 4 else None)
              for n in sorted(set(TAIL_PARTITIONS.values()) | {1})}
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracles = _oracles({name: (lambda n=name: _oracle(n, data)) for name in tpcds.TAIL_CLASSES})
    print(f"tail classes: inputs on the card in {t_ingest:.2f} s, oracles in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    for label, name, conf, must in TAIL_RUNS:
        ingested = inputs[TAIL_PARTITIONS.get(name, 1)]
        run = getattr(tpcds, f"run_{name}_class")
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(device="cuda", conf=conf, ingested=ingested)
        sort_checks = check_sorts(label, sorts)
        del sorts
        if sort_checks:  # the checks' large temporaries leave the allocator cold
            torch.cuda.empty_cache()
            run(device="cuda", conf=conf, ingested=ingested)
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        t0 = time.perf_counter()
        got = run(device="cuda", conf=conf, ingested=ingested, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        want = oracles[name]
        for ans in (warm, got):
            _assert_answer(label, ans, want, allow_empty=True)
        _assert_planned_launches(label, shapes, launches, sorts="bitonic_sort" in must)
        assert len(sort_checks) == len(shapes), (label, len(sort_checks), shapes)
        _assert_must_launch(label, launches, must)
        rows = len(next(iter(got.values())))
        print(f"{label}-class: wall {wall:.4f} s, {rows} result rows, kernel sorts (NP, P) "
              f"{shapes}, launches {launches}, peak device memory {peak / 2**30:.3f} GiB, "
              f"{_from_bytes(stats)}", flush=True)
        _print_timers(label, stats)
        top = sorted(stats["timers"].items(), key=lambda kv: -kv[1])[:5]
        out[label] = {"wall_s": wall, "launches": launches, "peak_bytes": peak,
                      "result_rows": rows, "sort_shapes": shapes, "sort_checks": sort_checks,
                      "top_timers_s": dict(top),
                      "sort_timers_s": {k: v for k, v in stats["timers"].items()
                                        if k.startswith("SortExec.")},
                      **{k: v for k, v in stats.items() if k != "timers"}}
    return out


#: phase 11: timed runs of each window, expand and scalar-subquery class
WINDOW_TIMED_RUNS = 2
#: the whole script's timed runs of each window class: one, so that the
#: script ends inside its time limit (``--window-only`` keeps two)
WINDOW_TIMED_RUNS_IN_SCRIPT = 1
#: the classes whose WindowExec sorts (K3, and K4 where P > 32,768)
WINDOWED = ("windowed", "windowed2", "q51", "q23", "q46")
#: running float sums: (class, column, partition key column)
WINDOW_RUNNING = (("windowed2", "run_sum", "ss_item_sk"), ("q51", "run_rev", "item"))


def _window_inputs(data) -> dict:
    """Each class's inputs on the card (set-up): the fact in one partition,
    in two (windowed: one task over both), de-duplicated (windowed2)."""
    from auron_tpu_torch.models import tpcds

    one, two = (tpcds.ingest_q3(data, n, device="cuda") for n in (1, 2))
    return {name: (two if name == "windowed" else tpcds.ingest_windowed2(data, "cuda")
                   if name == "windowed2" else one)
            for name in tpcds.WINDOW_CLASSES}


def _assert_window_answer(name: str, got: dict, want: dict) -> dict:
    """The class's answer against its oracle: keys, counts, ranks, lag
    values and validity and the row order exactly, revenues and sums at
    rel 1e-9, running sums within ``tpcds.running_sum_bound``; windowed,
    which ranks by a float alone, under its tie rule (``want`` is then its
    groups' ``windowed_ranks``). Returns the running sums' largest error."""
    import numpy as np

    from auron_tpu_torch.models import tpcds

    if name == "windowed":
        assert len(got["rk"]) > 0, name
        bad = tpcds.windowed_mismatch(got, want)
        assert bad is None, ("windowed", bad)
        return {"ties": int(((want["lo"] <= 2) & (want["hi"] > want["lo"])).sum())}
    assert sorted(got) == sorted(want) and len(next(iter(want.values()))) > 0, name
    running = {col: part for cls, col, part in WINDOW_RUNNING if cls == name}
    err = {}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (name, k, g.shape, w.shape)
        if k in running:
            bound = tpcds.running_sum_bound(want[running[k]], w)
            diff = np.abs(g - w)
            assert (diff <= bound).all(), (name, k, float(diff.max()))
            err[k] = {"max_abs_err": float(diff.max()),
                      "max_err_over_bound": float((diff / bound).max()),
                      "max_bound": float(bound.max())}
        elif k in ("rev", "s"):
            assert np.isfinite(g).all(), (name, k)
            _assert_close(g, w)
        else:
            assert _np_equal(g, w), (name, k, g[:10], w[:10])
    return err


def run_window_classes(data, timed_runs: int = WINDOW_TIMED_RUNS) -> dict:
    """Phase 11: each of tpcds.WINDOW_CLASSES over the whole fact table: a
    warm-up (its kernel sorts recorded, then sorted once more by K3/K4 and
    by the plain network on the card, bit for bit), then ``timed_runs``
    timed runs, whose bitonic launches must each equal ``sort_plan``'s for
    the recorded sorts. A windowed class must launch K3, and K4 where a
    sort is past one cluster; every answer equals its numpy oracle."""
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    inputs = _window_inputs(data)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracles = _oracles({name: (lambda n=name: tpcds.windowed_ranks(data) if n == "windowed"
                               else getattr(tpcds, f"{n}_class_oracle")(data))
                        for name in tpcds.WINDOW_CLASSES})
    print(f"window classes: inputs on the card in {t_ingest:.2f} s, oracles in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    for name in tpcds.WINDOW_CLASSES:
        ingested = inputs[name]
        run = getattr(tpcds, f"run_{name}_class")
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(device="cuda", ingested=ingested)
        sort_checks = check_sorts(name, sorts)
        del sorts
        if sort_checks:  # the checks' large temporaries leave the allocator cold
            torch.cuda.empty_cache()
            run(device="cuda", ingested=ingested)
        walls, peaks, runs_launches = [], [], []
        for k in range(timed_runs):
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats = {} if k == 0 else None
            t0 = time.perf_counter()
            got = run(device="cuda", ingested=ingested, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            runs_launches.append(_launches())
            peaks.append(torch.cuda.max_memory_allocated())
            if k == 0:
                first, first_stats = got, stats
            _assert_planned_launches(name, shapes, runs_launches[-1], sorts=name in WINDOWED)
        # the running sums' largest error over the three answers held
        # (windowed: the groups ranked <= 2 whose revenue ties another's)
        err: dict = {}
        for ans in (warm, first, got):
            for col, e in _assert_window_answer(name, ans, oracles[name]).items():
                if col == "ties" or e["max_abs_err"] >= err.get(col, {"max_abs_err": -1.0})[
                        "max_abs_err"]:
                    err[col] = e
        assert len(sort_checks) == len(shapes), (name, len(sort_checks), shapes)
        ORACLES[name] = oracles[name]
        must = ("bitonic_sort",) if name in WINDOWED else ()
        if any(s["P"] > 32768 for s in sort_checks):
            must += ("bitonic_merge",)
        for launches in runs_launches:
            _assert_must_launch(name, launches, must)
        rows = len(next(iter(got.values())))
        counters = first_stats["counters"]
        dense = counters.get("HashAggExec.elapsed_compute_n", 0)
        print(f"{name}-class: walls {', '.join(f'{w:.4f}' for w in walls)} s, {rows} result "
              f"rows, kernel sorts (NP, P) {shapes}, launches {runs_launches[0]}, peak device "
              f"memory {max(peaks) / 2**30:.3f} GiB, aggregate batches folded in a dense "
              f"table {dense}, generic merges {counters.get('HashAggExec.num_merges', 0)}"
              + (f", tied groups at rank <= 2 {err['ties']}" if "ties" in err
                 else f", running-sum error {err}" if err else "")
              + f", {_from_bytes(first_stats)}", flush=True)
        _print_timers(name, first_stats)
        top = sorted(first_stats["timers"].items(), key=lambda kv: -kv[1])[:5]
        out[name] = {"wall_s": walls[0], "walls_s": walls, "launches": runs_launches[0],
                     "launches_per_run": runs_launches, "peak_bytes": max(peaks),
                     "peaks_bytes": peaks, "result_rows": rows, "sort_shapes": shapes,
                     "sort_checks": sort_checks, "top_timers_s": dict(top),
                     "counters": counters, "running_sum_error": err}
    del inputs
    return out


def profile_window_classes(data, window: dict) -> None:
    """``--profile``: one more run of each window class under torch.profiler."""
    from auron_tpu_torch.models import tpcds

    inputs = _window_inputs(data)
    for name in tpcds.WINDOW_CLASSES:
        window[name]["profile"] = profile_run(name, lambda: getattr(
            tpcds, f"run_{name}_class")(device="cuda", ingested=inputs[name]))


def _fmt_s(walls: dict) -> str:
    return ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())


def _print_exchanges(label: str, stats: dict) -> None:
    for ex in stats["exchanges"]:
        print(f"  {label} exchange {ex['id']}: mode {ex['mode']}, map {ex['map_s']:.4f} s, "
              f"exchange {ex['exchange_s']:.4f} s, slot_cap {ex['slot_cap']}, coalesced "
              f"{ex['coalesced_groups']}, routing [src][dst] {ex['routing']}"
              + (f", skew tasks {ex['skew_tasks']}" if ex["skew_tasks"] else ""), flush=True)


def _shards(stats: dict) -> int:
    """Source shards over every exchange of a driver run: K2 runs once a shard."""
    return sum(len(ex["routing"]) for ex in stats["exchanges"])


def run_q72_mesh_phase(data, fact, oracle: dict, n_parts: int = 4) -> dict:
    """Phase 9a: q72-mesh on the mesh and the file transport, warm-up then
    timed; each equals the oracle and the two agree."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_q72(data, n_parts, device="cuda", fact=fact)
    out, answers = {}, {}
    for mode in ("mesh", "file"):
        conf = {"exchange.mode": mode}
        warm = tpcds.run_q72_mesh(n_parts=n_parts, device="cuda", conf=conf, ingested=ingested)
        _reset_launches()
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        got = tpcds.run_q72_mesh(n_parts=n_parts, device="cuda", conf=conf, stats=stats,
                                 ingested=ingested)
        wall = time.perf_counter() - t0
        launches = _launches()
        label = f"q72-mesh ({mode})"
        for ans in (warm, got):
            _assert_answer(label, ans, oracle)
        assert all(ex["mode"] == mode for ex in stats["exchanges"]), stats["exchanges"]
        assert launches["partition_histogram"] == _shards(stats), (label, launches)
        _assert_must_launch(label, launches, ("murmur3_pmod", "partition_histogram"))
        answers[mode] = got
        print(f"{label}: P={n_parts}, wall {wall:.4f} s (reduce {stats['reduce_s']:.4f} s), "
              f"peak device memory {stats['peak_bytes'] / 2**30:.3f} GiB, launches {launches}, "
              f"the driver's plan proto "
              f"{len(tpcds.q72_mesh_plan(n_parts).SerializeToString()):,} B", flush=True)
        _print_exchanges(label, stats)
        out[mode] = {"wall_s": wall, **stats, "launches": launches}
    for k in answers["mesh"]:
        if k in FLOAT_SUMS:
            _assert_close(answers["mesh"][k], answers["file"][k])
        else:
            assert _np_equal(answers["mesh"][k], answers["file"][k]), ("q72-mesh transports", k)
    return out


def run_skew_phase(n: int, n_parts: int = 4) -> dict:
    """Phase 9b: the skew plan on the file transport with skew-join
    splitting on, then off: warm-up (kernel sorts recorded and checked) and
    timed run each; the split run must widen the join stage."""
    import torch

    from auron_tpu_torch.models import tpcds

    fact, dim = tpcds.skew_data(n, 0.7)
    oracle = tpcds.skew_join_oracle(fact, dim)
    per = (n + n_parts - 1) // n_parts
    ingested = {"skew_l": tpcds.to_batches(fact, n_parts, per, device="cuda"),
                "skew_r": tpcds.to_batches(dim, n_parts, per, device="cuda")}
    out, answers = {}, {}
    for enable in (True, False):
        conf = {"exchange.skew.join.enable": enable}
        label = f"skew join (split {'on' if enable else 'off'})"
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = tpcds.run_skew_join(n_parts=n_parts, device="cuda", conf=conf,
                                       ingested=ingested)
        sort_checks = check_sorts(label, sorts)
        del sorts
        torch.cuda.empty_cache()  # the checks' large temporaries leave the allocator cold
        tpcds.run_skew_join(n_parts=n_parts, device="cuda", conf=conf, ingested=ingested)
        _reset_launches()
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        got = tpcds.run_skew_join(n_parts=n_parts, device="cuda", conf=conf, stats=stats,
                                  ingested=ingested)
        wall = time.perf_counter() - t0
        launches = _launches()
        for ans in (warm, got):
            _assert_answer(label, ans, oracle)
        tasks = {ex["id"]: ex["skew_tasks"] for ex in stats["exchanges"]}
        if enable:
            assert tasks["skew_ex_l"] and len(tasks["skew_ex_l"]) > n_parts, (label, tasks)
            assert len(tasks["skew_ex_r"]) == len(tasks["skew_ex_l"]), tasks
        else:
            assert not any(tasks.values()), (label, tasks)
        assert launches["partition_histogram"] == _shards(stats), (label, launches)
        _assert_planned_launches(label, shapes, launches)
        assert len(sort_checks) == len(shapes), (label, len(sort_checks), shapes)
        _assert_must_launch(label, launches, ("murmur3_pmod", "partition_histogram",
                                              "bitonic_sort", "bitonic_merge"))
        answers[enable] = got
        print(f"{label}: {n} fact rows, P={n_parts}, wall {wall:.4f} s (reduce "
              f"{stats['reduce_s']:.4f} s), join-stage tasks "
              f"{len(tasks['skew_ex_l'] or range(n_parts))}, kernel sorts (NP, P) {shapes}, "
              f"peak device memory {stats['peak_bytes'] / 2**30:.3f} GiB, launches {launches}, "
              f"the driver's plan proto "
              f"{len(tpcds.skew_join_plan(n_parts).SerializeToString()):,} B", flush=True)
        _print_exchanges(label, stats)
        out["on" if enable else "off"] = {"wall_s": wall, **stats, "launches": launches,
                                          "sort_shapes": shapes, "sort_checks": sort_checks}
    for k in answers[True]:
        assert _np_equal(answers[True][k], answers[False][k]), ("skew split on/off", k)
    return out


#: phase 12: the runs under a memory budget, as (label, class, conf, kernels
#: the timed runs must launch, the operator counter that must show at least
#: two spills). q67's partial aggregate parks its state in host RAM, and
#: past a 128 MiB host ledger the coldest runs demote to disk; q72's
#: probe-side SortExec (elision build) spills its pending run by memory,
#: long before the 2^23-row threshold, and merges the runs with K4; each
#: q93 map task's shuffle staging parks its blocks in .shuffle.spill files
SPILL_RUNS = (
    ("q67 (budget)", "q67", {"memory.hbm.budget.bytes": 384 << 20,
                             "memory.host.spill.budget.bytes": 128 << 20},
     (), "HashAggExec.spilled_aggs"),
    ("q72 (build, budget)", "q72", {"auron.smj.elide.sorts": "build",
                                    "memory.hbm.budget.bytes": 256 << 20},
     ("murmur3_pmod", "bitonic_sort", "bitonic_merge"), "SortExec.spilled_runs"),
    ("q93 (budget)", "q93", {"memory.hbm.budget.bytes": 16 << 20},
     ("murmur3_pmod",), "ShuffleWriterExec.spilled_shuffle_runs"),
)
#: one timed run under each budget, so that the whole script ends inside
#: its time limit
SPILL_TIMED_RUNS = 1
#: the default-conf runs of phases 8 and 10 whose SortExecs the 2^23-row
#: threshold may spill, with their numbers before the spill path (PERF.md,
#: H100 80GB HBM3 at 700 W), printed beside this run's
SPILL_DEFAULT = {"q72 (build)": "before: wall 6.7-8.1 s, peak 5.65 GiB, K3 4, K4 104",
                 "q17": "before: wall 0.746-0.949 s, peak 7.507 GiB, K3 2, K4 64"}


def _assert_spill_answer(label: str, name: str, got: dict, want: dict) -> None:
    if name == "q93":
        _assert_q93(got, want)
    elif name == "q67":
        _assert_window_answer(name, got, want)
    else:
        _assert_answer(label, got, want)


def run_spill_phase(data, gate: dict, tail: dict, q93_k1: int) -> dict:
    """Phase 12. First the default conf: q72 (build) and q17 from phases 8
    and 10, their spilled runs, merge time, wall and peak. Then each of
    SPILL_RUNS with only its own inputs on the card: a warm-up (its kernel
    sorts and run merges recorded, then run once more by K3/K4 and by the
    plain network on the card, bit for bit), one timed run without the
    budget, then SPILL_TIMED_RUNS timed runs under it, each equal to the
    oracle and to the unbudgeted answer, each with at least two spills,
    its bitonic launches those ``sort_plan`` lists for the recorded sorts
    and merges; q93 launches K1 as often as in phase 5."""
    import torch

    from auron_tpu_torch.models import tpcds

    out: dict = {"default": {}}
    for label, prev in SPILL_DEFAULT.items():
        r = gate.get(label) or tail[label]
        timers = r.get("timers") or r["sort_timers_s"]
        spilled = r["counters"].get("SortExec.spilled_runs", 0)
        merges = [s for s in r["sort_shapes"] if len(s) == 3]
        assert spilled or not merges, (label, spilled, merges)  # runs merge only after a spill
        d = {"spilled_runs": spilled, "merge_time_s": timers.get("SortExec.merge_time", 0.0),
             "spill_time_s": timers.get("SortExec.spill_time", 0.0), "wall_s": r["wall_s"],
             "peak_bytes": r["peak_bytes"], "run_merges": merges, "launches": r["launches"]}
        out["default"][label] = d
        print(f"spill (default conf) {label}: spilled runs {spilled}, run merges (NP, P) "
              f"{[m[:2] for m in merges]}, merge_time {d['merge_time_s']:.4f} s, spill_time "
              f"{d['spill_time_s']:.4f} s, wall {d['wall_s']:.4f} s, peak "
              f"{d['peak_bytes'] / 2**30:.3f} GiB, launches {r['launches']} ({prev})", flush=True)
    assert out["default"]["q17"]["spilled_runs"] >= 2, out["default"]["q17"]
    for label, name, conf, must, counter in SPILL_RUNS:
        t0 = time.perf_counter()
        ingested = (tpcds.ingest_q3(data, 1, device="cuda") if name == "q67" else
                    getattr(tpcds, f"ingest_{name}")(data, 4, device="cuda"))
        torch.cuda.synchronize()
        print(f"{label}: inputs on the card in {time.perf_counter() - t0:.2f} s", flush=True)
        run = getattr(tpcds, f"run_{name}_class")
        oracle = ORACLES[name]
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(device="cuda", conf=conf, ingested=ingested)
        sort_checks = check_sorts(label, sorts)
        del sorts
        torch.cuda.empty_cache()
        runs = []
        # the class without a budget, then the timed budgeted runs, in one
        # allocator state and with only this class's inputs resident
        for k in range(1 + SPILL_TIMED_RUNS):
            run_conf = ({c: v for c, v in conf.items() if not c.startswith("memory.")}
                        if k == 0 else conf)
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            t0 = time.perf_counter()
            got = run(device="cuda", conf=run_conf, ingested=ingested, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            mem, counters = stats["memory"], stats["counters"]
            spill_counters = {c: v for c, v in counters.items() if "spill" in c}
            if k == 0:
                unbudgeted = got
                for ans in (warm, got):
                    _assert_spill_answer(label, name, ans, oracle)
                free = {"wall_s": wall, "peak_bytes": peak, "launches": launches,
                        "spill_counters": spill_counters}
                print(f"{label} without a budget: wall {wall:.4f} s, peak device memory "
                      f"{peak / 2**30:.3f} GiB, spill counters {spill_counters}, launches "
                      f"{launches}, {_from_bytes(stats)}", flush=True)
                continue
            _assert_spill_answer(label, name, got, oracle)
            _assert_spill_answer(label, name, got, unbudgeted)
            assert counters.get(counter, 0) >= 2 and mem["num_spills"] >= 2, (label, counters,
                                                                               mem)
            _assert_planned_launches(label, shapes, launches, sorts="bitonic_sort" in must)
            _assert_must_launch(label, launches, must)
            if name == "q93":
                assert launches["murmur3_pmod"] == q93_k1, (label, launches, q93_k1)
            spill_timers = {t: v for t, v in stats["timers"].items()
                            if t.endswith(("spill_time", "merge_time"))}
            runs.append({"wall_s": wall, "peak_bytes": peak, "launches": launches,
                         "memory": mem, "spill_counters": spill_counters,
                         "spill_timers_s": spill_timers})
            print(f"{label}: budget {conf['memory.hbm.budget.bytes']} B (x memory.fraction: "
                  f"{mem['budget_bytes']} B), wall {wall:.4f} s, peak device memory "
                  f"{peak / 2**30:.3f} GiB, num_spills {mem['num_spills']}, num_waits "
                  f"{mem['num_waits']}, spill counters {spill_counters}, spill/merge timers "
                  f"{({t: round(v, 4) for t, v in spill_timers.items()})} s, host ledger "
                  f"demotions {mem['demotions']} ({mem['demoted_bytes']} B), bytes parked on "
                  f"host {mem['host_bytes']}, on disk {mem['disk_bytes']}, kernel sorts and "
                  f"merges (NP, P[, merge]) {shapes}, launches {launches}, "
                  f"{_from_bytes(stats)}", flush=True)
        assert len(sort_checks) == len(shapes), (label, len(sort_checks), shapes)
        out[label] = {"conf": conf, "runs": runs, "unbudgeted": free, "wall_s": runs[0]["wall_s"],
                      "launches": runs[0]["launches"], "sort_shapes": shapes,
                      "sort_checks": sort_checks}
        del ingested, warm, got, unbudgeted
    return out


def profile_q42(ingested: dict) -> dict:
    """One more q42 run under torch.profiler (``profile_run``), plus the
    operator metric tree's host timers."""
    from auron_tpu_torch.models import tpcds

    stats: dict = {}

    def run():
        tpcds.run_q42_class(device="cuda", ingested=ingested, stats=stats)

    out = profile_run("q42", run)
    out["operator_host_ms"] = {k: v * 1e3 for k, v in stats["timers"].items()}
    _print_timers("q42", stats)
    return out


#: phase 13: timed runs of q33; the join-tail sweep's probe (fact rows whose
#: ss_item_sk is below the limit) and join types; the predictor A/B classes
JOIN_TAIL_TIMED_RUNS = 3
SWEEP_ITEM_LIMIT = 13_500
SWEEP_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti", "existence")
AB_CLASSES = ("q42", "q3", "q6", "q18")
AB_TIMED_MODES = ("on", "off")


def _assert_equal_or_close(label: str, got: dict, want: dict) -> None:
    """Keys exactly equal, float columns at rel 1e-9, every other column exact."""
    import numpy as np

    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert np.isfinite(g).all(), (label, k)
            _assert_close(g, w)
        else:
            assert _np_equal(g, w), (label, k, g[:10], w[:10])


def run_q33_phase(data, ingested) -> dict:
    """q33 (two aggregate branches of the whole fact FULL OUTER joined by
    item): a warm-up, then JOIN_TAIL_TIMED_RUNS timed runs, each equal to
    its oracle."""
    import torch

    from auron_tpu_torch.models import tpcds

    oracle = _oracle("q33", data)
    _assert_equal_or_close("q33 (warm-up)", tpcds.run_q33_class(device="cuda",
                                                                ingested=ingested), oracle)
    walls, peaks, launches, stats = [], [], [], {}
    for _ in range(JOIN_TAIL_TIMED_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        got = tpcds.run_q33_class(device="cuda", ingested=ingested, stats=stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(_launches())
        peaks.append(torch.cuda.max_memory_allocated())
        _assert_equal_or_close("q33", got, oracle)
    n_lo, n_hi = int((~got["lo_valid"]).sum()), int((~got["hi_valid"]).sum())
    print(f"q33-class: walls {[round(w, 4) for w in walls]} s, {len(got['i'])} items "
          f"({n_lo} without a low-quantity sale, {n_hi} without a high one), launches "
          f"{launches[-1]}, peak device memory {max(peaks) / 2**30:.3f} GiB, counters "
          f"{stats.get('counters')}, {_from_bytes(stats)}", flush=True)
    _print_timers("q33", stats)
    return {"walls_s": walls, "peak_bytes": max(peaks), "launches": launches[-1],
            "launches_per_run": launches, "result_rows": len(got["i"]),
            "null_lo": n_lo, "null_hi": n_hi, "counters": stats.get("counters", {})}


def _sweep_inputs(data, fact) -> tuple[dict, dict]:
    """(device resources, host arrays for the oracle): the fact in one
    partition, build U (the items with an even i_item_sk: 9,000 unique keys
    at SF 8, those from 13,500 up without a probe row) and build D (U twice:
    every key twice)."""
    import numpy as np

    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch

    it, ss = data.item.columns, data.store_sales.columns
    for table, cols in ((data.item, ("i_item_sk", "i_brand_id")),
                        (data.store_sales, ("ss_item_sk", "ss_ext_sales_price"))):
        assert all(table.validity(c).all() for c in cols), "the sweep's oracle assumes no NULL"
    even = it["i_item_sk"] % 2 == 0
    uk, uv = it["i_item_sk"][even].astype(np.int64), it["i_brand_id"][even].astype(np.int32)
    schema = T.Schema((T.Field("b_key", T.INT64), T.Field("b_val", T.INT32)))
    keep = ss["ss_item_sk"] < SWEEP_ITEM_LIMIT
    host = {"probe": (ss["ss_item_sk"][keep].astype(np.int64), ss["ss_ext_sales_price"][keep]),
            "U": (uk, uv.astype(np.float64)),
            "D": (np.concatenate([uk, uk]), np.concatenate([uv, uv]).astype(np.float64))}
    res = {"sweep_fact": fact,
           "sweep_U": [[Batch.from_numpy([uk, uv], schema, device="cuda")]],
           "sweep_D": [[Batch.from_numpy([np.concatenate([uk, uk]), np.concatenate([uv, uv])],
                                         schema, device="cuda")]]}
    return res, host


def _sweep_plan(kind: str, jt: str, side: str, build: str):
    """The probe (the fact's rows below SWEEP_ITEM_LIMIT, as (key, price))
    joined with build U or D: a broadcast hash join with the build on
    ``side``, or a sort-merge join (build on the right) over two SortExecs."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.exec.basic import FilterExec, ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec
    from auron_tpu_torch.exec.sort_exec import SortExec
    from auron_tpu_torch.exprs.ir import BinaryOp, col, lit
    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.ops.sortkeys import SortSpec

    probe = ProjectExec(
        FilterExec(ResourceScanExec(tpcds.STORE_SALES_SCHEMA, "sweep_fact"),
                   [BinaryOp("lt", col(1), lit(SWEEP_ITEM_LIMIT))]),
        [col(1), col(4)], ["p_key", "p_val"])
    bscan = ResourceScanExec(T.Schema((T.Field("b_key", T.INT64), T.Field("b_val", T.INT32))),
                             f"sweep_{build}")
    if kind == "smj":
        return SortMergeJoinExec(SortExec(probe, [col(0)], [SortSpec()]),
                                 SortExec(bscan, [col(0)], [SortSpec()]),
                                 [col(0)], [col(0)], jt)
    left, right = (probe, bscan) if side == "right" else (bscan, probe)
    return BroadcastHashJoinExec(left, right, [col(0)], [col(0)], jt, build_side=side)


def _sweep_stats(batches, jt: str) -> dict:
    """Row count, rows whose left or right columns are NULL-extended, key
    sums and value sums (each side's valid rows), and for existence the
    true flags: reduced on the card batch by batch, one read at the end."""
    import torch

    ints = floats = None
    for b in batches:
        sel = b.device.sel
        vals, valid = b.device.values, b.device.validity
        n = len(vals)

        def isum(x, m):
            return torch.where(m, x.to(torch.int64), 0).sum()

        def fsum(x, m):
            return torch.where(m, x.to(torch.float64), 0.0).sum()

        zero = torch.zeros((), dtype=torch.int64, device=sel.device)
        lk_ok = sel & valid[0]
        rk_ok = sel & valid[2] if n == 4 else sel & False
        i = torch.stack([sel.sum(), (sel & ~valid[0]).sum(),
                         (sel & ~valid[2]).sum() if n == 4 else zero,
                         isum(vals[0], lk_ok), isum(vals[2], rk_ok) if n == 4 else zero,
                         (sel & vals[2]).sum() if jt == "existence" else zero])
        f = torch.stack([fsum(vals[1], sel & valid[1]),
                         fsum(vals[3], sel & valid[3]) if n == 4 else
                         torch.zeros((), dtype=torch.float64, device=sel.device)])
        ints = i if ints is None else ints + i
        floats = f if floats is None else floats + f
    i, f = ints.tolist(), floats.tolist()
    return {"rows": i[0], "l_null": i[1], "r_null": i[2], "l_key": i[3], "r_key": i[4],
            "n_true": i[5], "l_val": f[0], "r_val": f[1]}


def _sweep_oracle(jt: str, left, right) -> dict:
    """``_sweep_stats`` of the join of (keys, values) ``left`` and ``right``,
    from per-key counts (no key is NULL)."""
    import numpy as np

    (lk, lv), (rk, rv) = left, right
    K = int(max(lk.max(initial=0), rk.max(initial=0))) + 1
    cl, cr = np.bincount(lk, minlength=K), np.bincount(rk, minlength=K)
    sl, sr = np.bincount(lk, lv, minlength=K), np.bincount(rk, rv, minlength=K)
    keys = np.arange(K, dtype=np.int64)
    out = dict.fromkeys(("rows", "l_null", "r_null", "l_key", "r_key", "n_true"), 0)
    out.update(l_val=0.0, r_val=0.0)
    lm, rm = cr[lk] > 0, cl[rk] > 0
    if jt in ("left_semi", "left_anti", "existence"):
        rows = lm if jt == "left_semi" else (~lm if jt == "left_anti" else np.ones_like(lm))
        out.update(rows=int(rows.sum()), l_key=int(lk[rows].sum()), l_val=float(lv[rows].sum()),
                   n_true=int(lm.sum()) if jt == "existence" else 0)
        return out
    pairs = cl * cr
    out.update(rows=int(pairs.sum()), l_key=int((keys * pairs).sum()),
               r_key=int((keys * pairs).sum()), l_val=float((sl * cr).sum()),
               r_val=float((sr * cl).sum()))
    if jt in ("left", "full"):  # left rows without a match, right side NULL
        out["rows"] += int((~lm).sum())
        out["r_null"] += int((~lm).sum())
        out["l_key"] += int(lk[~lm].sum())
        out["l_val"] += float(lv[~lm].sum())
    if jt in ("right", "full"):
        out["rows"] += int((~rm).sum())
        out["l_null"] += int((~rm).sum())
        out["r_key"] += int(rk[~rm].sum())
        out["r_val"] += float(rv[~rm].sum())
    return out


def _sweep_run(kind, jt, side, build, res) -> dict:
    """One sweep case through the task runtime: its ``_sweep_stats``."""
    from auron_tpu_torch.runtime.task import TaskRuntime
    from auron_tpu_torch.utils.config import Configuration

    rt = TaskRuntime(_sweep_plan(kind, jt, side, build), resources=dict(res),
                     conf=Configuration({}), device="cuda")
    try:
        return _sweep_stats(rt, jt)
    finally:
        rt.finalize()


def _sweep_case(kind, jt, side, build, res, host, record_sorts: bool) -> dict:
    import torch

    label = f"sweep {kind} {jt} build {build}" + ("" if kind == "smj" else f" on the {side}")
    sorts: list = []
    shapes: list = []
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if record_sorts:
            stack.enter_context(_recording_sorts(sorts))
        stack.enter_context(_recording_kernel_sorts(shapes))
        got = _sweep_run(kind, jt, side, build, res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    left, right = ((host["probe"], host[build]) if side == "right" or kind == "smj"
                   else (host[build], host["probe"]))
    want = _sweep_oracle(jt, left, right)
    for k, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=1e-9, abs_tol=1e-6), (label, k, got[k], w)
        else:
            assert got[k] == w, (label, k, got[k], w)
    assert want["rows"] > 0, (label, "empty oracle")
    if kind == "smj":
        _assert_planned_launches(label, shapes, launches)
        _assert_must_launch(label, launches, ("bitonic_sort", "bitonic_merge"))
    sort_checks = check_sorts(label, sorts) if record_sorts else []
    print(f"{label}: wall {wall:.4f} s, rows {got['rows']} (left NULL {got['l_null']}, right "
          f"NULL {got['r_null']}), launches {launches}", flush=True)
    return {"wall_s": wall, "stats": got, "launches": launches, "sort_shapes": shapes,
            "sort_checks": sort_checks}


#: the sweep cases and A/B runs ``--profile`` traces: (kind, type, side, build)
SWEEP_PROFILED = (("bhj", "full", "right", "U"), ("bhj", "full", "left", "D"),
                  ("smj", "full", "right", "D"))


def run_join_tail_sweep(data, fact, profile: bool = False) -> dict:
    """Every join type x build side, BHJ over builds U and D, and SMJ (build
    on the right) over SortExec inputs, each equal to its numpy oracle. The
    first SMJ case of each build records its kernel sorts and run merges,
    held against the plain network on the card."""
    res, host = _sweep_inputs(data, fact)
    out = {}
    if profile:
        out["profiles"] = {f"{k} {jt} {b} {side}": profile_run(
            f"sweep {k} {jt} build {b} ({side})", lambda: _sweep_run(k, jt, side, b, res))
            for k, jt, side, b in SWEEP_PROFILED}
    for build in ("U", "D"):
        for side in ("right", "left"):
            for jt in SWEEP_TYPES:
                r = _sweep_case("bhj", jt, side, build, res, host, False)
                out[f"bhj {jt} {build} {side}"] = r
        for i, jt in enumerate(SWEEP_TYPES):
            r = _sweep_case("smj", jt, "right", build, res, host, record_sorts=i == 0)
            out[f"smj {jt} {build}"] = r
    return out


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (so that float ``index_add_`` folds
    sum in one order), warnings of ops without one collected and printed."""
    import warnings

    import torch

    prev, prev_warn = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield
        msgs = sorted({str(w.message).split("\n")[0][:120] for w in seen})
        if msgs:
            print(f"deterministic mode: ops without a deterministic version: {msgs}",
                  flush=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _ab_inputs(name: str, data, fact4) -> dict:
    from auron_tpu_torch.models import tpcds

    if name == "q42":
        return tpcds.ingest_q42(data, device="cuda")
    if name == "q6":
        return tpcds.ingest_q3(data, TAIL_PARTITIONS["q6"], device="cuda")
    return tpcds.ingest_q3(data, 4, device="cuda", fact=fact4)


def _join_reads(counters: dict) -> dict:
    """The join operators' read counters of one run."""
    out = {}
    for k, v in counters.items():
        op, name = k.split(".", 1)
        if op.endswith("JoinExec"):
            out[name] = out.get(name, 0) + v
    return out


def run_predictor_ab(data, fact4, profile: bool = False) -> dict:
    """q42, q3, q6 and q18 with ``exec.selectivity.predictor`` on and off:
    once each under deterministic algorithms, bit-identical; then timed
    runs (AB_TIMED_MODES), each equal to its oracle. With the predictor on,
    every probe stream through a unique-join compaction boundary makes
    exactly one blocking read (its seed). ``profile`` traces one run of
    q42 and of q3 in each mode."""
    import numpy as np
    import torch

    from auron_tpu_torch.models import tpcds

    out = {}
    for name in AB_CLASSES:
        ingested = _ab_inputs(name, data, fact4)
        run = getattr(tpcds, f"run_{name}_class")
        oracle = _oracle(name, data)

        def once(mode, stats=None):
            return run(device="cuda", conf={"exec.selectivity.predictor": mode},
                       ingested=ingested, stats=stats)

        with _deterministic():
            a, b = once("on"), once("off")
        assert sorted(a) == sorted(b), name
        for k in a:
            assert np.array_equal(a[k], b[k]), (name, k, "predictor on and off differ")
        runs = []
        for mode in AB_TIMED_MODES:
            _reset_launches()
            torch.cuda.synchronize()
            stats: dict = {}
            t0 = time.perf_counter()
            got = once(mode, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _assert_equal_or_close(f"{name} (predictor {mode})", got, oracle)
            reads = _join_reads(stats.get("counters", {}))
            if mode == "on":
                assert reads.get("unique_streams", 0) > 0, (name, reads)
                assert reads.get("blocking_reads", 0) == reads["unique_streams"], (name, reads)
            runs.append({"mode": mode, "wall_s": wall, "join_reads": reads,
                         "launches": _launches(),
                         "agg_blocking_reads": stats.get("counters", {}).get(
                             "HashAggExec.blocking_reads", 0)})
            print(f"{name} predictor {mode}: wall {wall:.4f} s, join reads {reads}, "
                  f"{_from_bytes(stats)}", flush=True)
        out[name] = runs
        if profile and name in ("q42", "q3"):
            out[f"{name} profiles"] = {mode: profile_run(
                f"{name} (predictor {mode})", lambda: once(mode)) for mode in ("on", "off")}
        del ingested
        torch.cuda.empty_cache()
    return out


def run_join_tail_phase(data, profile: bool = False) -> tuple[dict, dict, dict]:
    """Phase 13: (q33, the sweep, the predictor A/B)."""
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    tail_in = tpcds.ingest_q3(data, 1, device="cuda")
    torch.cuda.synchronize()
    print(f"join tail: the fact in one partition on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    q33 = run_q33_phase(data, tail_in)
    if profile:
        q33["profile"] = profile_run("q33", lambda: tpcds.run_q33_class(
            device="cuda", ingested=tail_in))
    sweep = run_join_tail_sweep(data, tail_in["fact"], profile)
    del tail_in
    ab = run_predictor_ab(data, tpcds.to_batches(data.store_sales, 4, device="cuda"), profile)
    torch.cuda.empty_cache()
    return q33, sweep, ab


#: phase 14: (class, timed runs, kernels its timed runs must launch)
DECIMAL_RUNS = (("q9b", 1, ()), ("q3_decimal", 2, ()), ("q42_decimal", 2, ("bitonic_sort",)),
                ("windowed_decimal", 1, ("bitonic_sort", "bitonic_merge")))


def _decimal_inputs(data, name: str) -> dict:
    """One decimal class's inputs on the card (set-up)."""
    from auron_tpu_torch.models import tpcds

    if name == "q9b":
        return tpcds.ingest_q9b(data, "cuda")
    if name == "q42_decimal":
        return tpcds.ingest_q42(data, "cuda")
    return tpcds.ingest_q3(data, 4 if name == "q3_decimal" else 2, device="cuda")


def _assert_exact(label: str, got: dict, want: dict) -> None:
    """Every column equal, element for element (Decimals by value, a NULL
    as None), and the answer not empty."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        assert len(w) > 0, (label, k)
        assert got[k].tolist() == w.tolist(), (label, k, got[k][:5], w[:5])


def run_decimal_classes(data, profile: bool = False) -> dict:
    """Phase 14: each of DECIMAL_RUNS over the SF's data: a warm-up (its
    kernel sorts recorded, then checked on the card against the plain
    network), then its timed runs, whose bitonic launches equal
    ``sort_plan``'s for the recorded sorts; every answer equals its exact
    oracle."""
    import torch

    from auron_tpu_torch.models import tpcds

    out = {}
    for name, n_runs, must in DECIMAL_RUNS:
        t0 = time.perf_counter()
        ingested = _decimal_inputs(data, name)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = getattr(tpcds, f"{name}_class_oracle")(data)
        t_oracle = time.perf_counter() - t0
        run = getattr(tpcds, f"run_{name}_class")
        sorts: list = []
        shapes: list = []
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            warm = run(device="cuda", ingested=ingested)
        _assert_exact(f"{name} warm-up", warm, want)
        sort_checks = check_sorts(name, sorts)
        del sorts
        if sort_checks:
            torch.cuda.empty_cache()
            run(device="cuda", ingested=ingested)
        walls, peaks, runs_launches = [], [], []
        for k in range(n_runs):
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            t0 = time.perf_counter()
            got = run(device="cuda", ingested=ingested, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            runs_launches.append(_launches())
            peaks.append(torch.cuda.max_memory_allocated())
            _assert_exact(name, got, want)
            _assert_planned_launches(name, shapes, runs_launches[-1], sorts=bool(must))
            _assert_must_launch(name, runs_launches[-1], must)
            if k == 0:
                first_stats = stats
        assert len(sort_checks) == len(shapes), (name, len(sort_checks), shapes)
        counters = first_stats.get("counters", {})
        dec128 = sum(v for c, v in counters.items() if c.endswith("shuffle_enc_dec128"))
        if name == "q3_decimal":
            assert dec128 > 0, "q3 (decimal): no DEC128 column written"
        kernels = {k: runs_launches[0][k] for k in ("bitonic_sort", "bitonic_merge")}
        print(f"{name}: walls {', '.join(f'{w:.4f}' for w in walls)} s, peak device memory "
              f"{max(peaks) / 2**30:.3f} GiB, K3/K4 launches {kernels}, kernel sorts (NP, P) "
              f"{shapes}, DEC128 columns written {dec128}, ingest {t_ingest:.2f} s, oracle "
              f"{t_oracle:.2f} s, {len(next(iter(got.values())))} result rows, "
              f"{_from_bytes(first_stats)}; equal to the exact oracle", flush=True)
        _print_timers(name, first_stats)
        out[name] = {"wall_s": walls[0], "walls_s": walls, "launches": runs_launches[0],
                     "launches_per_run": runs_launches, "peak_bytes": max(peaks),
                     "peaks_bytes": peaks, "sort_shapes": shapes, "sort_checks": sort_checks,
                     "dec128_columns": dec128, "counters": counters,
                     "stage_s": first_stats.get("stage_s")}
        if profile and name in ("q3_decimal", "q42_decimal"):
            out[name]["profile"] = profile_run(name, lambda: run(device="cuda",
                                                                 ingested=ingested))
        del ingested
    return out


#: phase 15: the A/B paths, run with the defaults (this slice's fusion and
#: incremental keys on, as auto resolves on the card) and with every key of
#: the slice off (the behaviour before this slice)
FUSION_PATHS = ("q42", "q3", "q93", "q18", "q33", "q5", "q42_decimal", "q3-mesh")
FUSION_OFF = {"exec.fuse.enable": "off", "exec.filter.fuse": "false",
              "exec.fuse.agg.inputs": "false", "exec.fuse.probe": "off",
              "exec.fuse.shuffle": "off", "exec.agg.incremental.probe": "off",
              "exec.agg.incremental.mergepath": "off"}
FUSION_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit
#: the A/B paths profiled each way without --profile (q42 and q3: host
#: dispatch; the decimal q42: its cub sorts)
FUSION_PROFILED = ("q42", "q3", "q42_decimal")
#: the aggregate path counters phase 15 prints per path
AGG_PATH_COUNTERS = ("dense_batches", "probe_batches", "probe_miss_batches",
                     "generic_batches", "probe_hit_rows", "merge_path_merges",
                     "fp_collision_batches", "partial_agg_skipped", "num_merges")


def _fusion_inputs(name: str, data, fact4) -> dict:
    from auron_tpu_torch.models import tpcds

    if name in ("q42", "q42_decimal"):
        return tpcds.ingest_q42(data, device="cuda")
    if name == "q93":
        return tpcds.ingest_q93(data, 4, device="cuda", fact=fact4)
    if name == "q33":
        return tpcds.ingest_q3(data, 1, device="cuda")
    if name == "q5":
        return {"fact": fact4}
    return tpcds.ingest_q3(data, 4, device="cuda", fact=fact4)


def _fusion_runner(name: str, ingested: dict):
    from auron_tpu_torch.models import tpcds

    if name == "q3-mesh":
        return lambda conf, stats=None: tpcds.run_q3_mesh(
            n_parts=4, device="cuda", conf=conf, ingested=ingested, stats=stats)
    run = getattr(tpcds, f"run_{name}_class")
    return lambda conf, stats=None: run(device="cuda", conf=conf, ingested=ingested,
                                        stats=stats)


def _agg_paths(stats: dict) -> dict:
    """The aggregates' path counters of a run (those that are not 0) and
    their merge timers."""
    counters = stats.get("counters", {})
    out = {c: counters[f"HashAggExec.{c}"] for c in AGG_PATH_COUNTERS
           if counters.get(f"HashAggExec.{c}")}
    timers = stats.get("timers", {})
    out["merge_time_s"] = timers.get("HashAggExec.merge_time", 0.0)
    out["merge_path_s"] = timers.get("HashAggExec.merge_path_s", 0.0)
    return out


def _fusion_ab_path(name: str, data, fact4, profile: bool) -> dict:
    """One A/B path: per mode a warm-up, FUSION_TIMED_RUNS timed runs (each
    equal to the oracle, the modes equal to each other) and, for
    FUSION_PROFILED (every path with ``profile``), one profiled run; the
    walls, the fusion counters (captures, replays, eager segments by
    reason, graph-pool bytes), peak memory and the aggregate paths."""
    import torch

    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.plan import fusion

    t0 = time.perf_counter()
    ingested = _fusion_inputs(name, data, fact4)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    oracle_name = "q3" if name == "q3-mesh" else name
    want = ORACLES.get(oracle_name)
    if want is None:
        want = ORACLES[oracle_name] = getattr(tpcds, f"{oracle_name}_class_oracle")(data)
    run = _fusion_runner(name, ingested)
    check = _assert_exact if name == "q42_decimal" else (
        lambda label, got, w: _assert_equal_or_close(label, got, w))
    out = {"ingest_s": t_ingest}
    answers = {}
    for mode, conf in (("on", {}), ("off", dict(FUSION_OFF))):
        warm = run(conf)
        check(f"{name} fusion {mode} warm-up", warm, want)
        runs = []
        for i in range(FUSION_TIMED_RUNS):
            _reset_launches()
            fusion.reset_fusion_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            t0 = time.perf_counter()
            got = run(conf, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fs = fusion.fusion_stats()
            check(f"{name} fusion {mode} run {i}", got, want)
            answers.setdefault(mode, got)
            runs.append({"wall_s": wall, "launches": _launches(),
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "captures": fs["captures"], "replays": fs["replays"],
                         "segments": fs["segments"], "eager": fs["eager"],
                         "pool_bytes": fs["pool_bytes"], "evictions": fs["evictions"],
                         "agg": _agg_paths(stats),
                         "from_bytes": (None if name == "q3-mesh" else _from_bytes(stats))})
        if mode == "on":
            assert runs[-1]["captures"] == 0, (name, "the timed run captured", runs)
            if name in ("q42", "q3"):
                assert all(r["replays"] > 0 for r in runs), (name, "no fused stage replayed")
        else:
            assert all(r["replays"] == 0 and r["segments"] == 0 for r in runs), (name, runs)
        prof = None
        if profile or name in FUSION_PROFILED:
            prof = profile_run(f"{name} (fusion {mode})", lambda: run(conf))
        out[mode] = {"runs": runs, "profile": prof}
        r = runs[-1]
        walls = ", ".join("%.4f" % x["wall_s"] for x in runs)
        idle = "" if prof is None else f", idle share {prof['device_idle_share']:.3f}"
        print(f"{name} fusion {mode}: walls {walls} s, captures "
              f"{[x['captures'] for x in runs]}, replays {[x['replays'] for x in runs]}, "
              f"segments {r['segments']}, eager {r['eager']}, graph cache "
              f"{r['pool_bytes'] / 2**20:.1f} MiB, evictions "
              f"{[x['evictions'] for x in runs]}, peak "
              f"{max(x['peak_bytes'] for x in runs) / 2**30:.3f} GiB{idle}, aggregate paths "
              f"{r['agg']}" + (f", {r['from_bytes']}" if r["from_bytes"] else ""), flush=True)
        if name == "q42_decimal":
            print(f"{name} fusion {mode}: cub sorts {prof['cub_sorts']}", flush=True)
    _assert_equal_or_close(f"{name}: defaults against every key off", answers["on"],
                           answers["off"])
    if name == "q42_decimal":
        _assert_exact(f"{name}: defaults against every key off", answers["on"],
                      answers["off"])
    return out


def _fusion_probe_plan(data) -> dict:
    """The probe class over the whole fact (``tpcds.run_probe_agg_class``):
    a generic aggregate by (item, date), 32.85 M slots at SF 8, whose final
    aggregate probes its sorted state with every later batch. Defaults and
    every key off, a warm-up and a timed run each, equal to the numpy oracle
    and to each other (no warm-up: the plan captures no graph, its stages
    are pure column passthroughs); the probe's hit rows, merge-path merges
    and merge time both ways."""
    import numpy as np
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    ingested = {"probe_fact": tpcds.to_batches(data.store_sales, 1, device="cuda")}
    want = tpcds.probe_agg_class_oracle(data)
    t_setup = time.perf_counter() - t0
    out = {"setup_s": t_setup, "groups": int(len(want["item"]))}
    answers = {}
    for mode, conf in (("on", {}), ("off", dict(FUSION_OFF))):
        _reset_launches()
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        got = tpcds.run_probe_agg_class(device="cuda", conf=conf, ingested=ingested,
                                        stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, w in want.items():
            if k == "s":
                _assert_close(got[k], w)
            else:
                assert np.array_equal(got[k], w), ("probe class", mode, k)
        answers[mode] = got
        agg = _agg_paths(stats)
        out[mode] = {"wall_s": wall, "agg": agg, "launches": _launches()}
        print(f"probe class ({mode}): wall {wall:.4f} s, {out['groups']} groups, aggregate "
              f"paths (partial + final) {agg}, {_from_bytes(stats)}", flush=True)
    assert out["on"]["agg"].get("probe_hit_rows", 0) > 0, ("the probe class never hit", out["on"])
    assert "probe_batches" not in out["off"]["agg"], out["off"]
    for k in want:
        if k != "s":
            assert np.array_equal(answers["on"][k], answers["off"][k]), k
    _assert_close(answers["on"]["s"], answers["off"]["s"])
    return out


def run_fusion_phase(data, profile: bool = False) -> dict:
    """Phase 15: the A/B of this slice's keys over FUSION_PATHS, then the
    probe at full width (the probe class)."""
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    fact4 = tpcds.to_batches(data.store_sales, 4, device="cuda")
    torch.cuda.synchronize()
    print(f"fusion A/B: the fact in 4 partitions on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out = {name: _fusion_ab_path(name, data, fact4, profile) for name in FUSION_PATHS}
    del fact4
    torch.cuda.empty_cache()
    out["probe class"] = _fusion_probe_plan(data)
    torch.cuda.empty_cache()
    return out


#: phase 16: warm-up, then this many timed runs of each generate class
GENERATE_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit


def _generate_inputs(name: str, data) -> dict:
    """One generate class's inputs on the card (set-up): the item table, or
    the fact in 1 << 20-row batches with the dimensions."""
    from auron_tpu_torch.models import tpcds

    if name == "generate":
        return {"qg_item": tpcds.to_batches(data.item, 1, device="cuda")}
    return tpcds.ingest_q3(data, 1, device="cuda")


def run_generate_phase(data, profile: bool = False) -> dict:
    """Phase 16: the 42nd class (explode(split(i_tags, ',')) over item, count
    by tag) and the same explode over the whole fact after a broadcast join
    with item (count and price sum by tag): each a warm-up, then
    GENERATE_TIMED_RUNS timed runs equal to the numpy oracle (tags and counts
    exact, sums at rel 1e-9), exploding exactly the rows the data holds in
    at least ceil(rows / 65,536) chunks with ONE blocking read of the
    GenerateExec per input batch."""
    import torch

    from auron_tpu_torch.models import tpcds

    exploded = tpcds.exploded_rows(data)
    out = {}
    for name in tpcds.GENERATE_CLASSES:
        t0 = time.perf_counter()
        ingested = _generate_inputs(name, data)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = getattr(tpcds, f"{name}_class_oracle")(data)
        t_oracle = time.perf_counter() - t0
        run = getattr(tpcds, f"run_{name}_class")
        _assert_equal_or_close(f"{name} warm-up", run(device="cuda", ingested=ingested), want)
        walls, peaks, runs_launches, counts = [], [], [], []
        for k in range(GENERATE_TIMED_RUNS):
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            t0 = time.perf_counter()
            got = run(device="cuda", ingested=ingested, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            runs_launches.append(_launches())
            peaks.append(torch.cuda.max_memory_allocated())
            _assert_equal_or_close(name, got, want)
            c = stats["counters"]
            n = {"input_batches": c["GenerateExec.generate_batches"],
                 "output_chunks": c["GenerateExec.generate_chunks"],
                 "exploded_rows": c["GenerateExec.exploded_rows"],
                 "blocking_reads": c["GenerateExec.blocking_reads"]}
            counts.append(n)
            assert n["exploded_rows"] == exploded[name], (name, n, exploded[name])
            assert n["blocking_reads"] == n["input_batches"], (name, n)  # one a batch
            assert n["output_chunks"] >= -(-n["exploded_rows"] // (1 << 16)), (name, n)
            if k == 0:
                first_stats = stats
        fusion = first_stats["fusion"]
        print(f"{name}: walls {', '.join(f'{w:.4f}' for w in walls)} s, input batches "
              f"{counts[0]['input_batches']}, output chunks {counts[0]['output_chunks']}, "
              f"exploded rows {counts[0]['exploded_rows']:,}, GenerateExec blocking reads "
              f"{counts[0]['blocking_reads']}, peak device memory {max(peaks) / 2**30:.3f} GiB, "
              f"fusion replays {fusion['replays']} captures {fusion['captures']}, ingest "
              f"{t_ingest:.2f} s, oracle {t_oracle:.2f} s, {len(got['tag'])} tags, "
              f"{_from_bytes(first_stats)}; equal to the oracle", flush=True)
        _print_timers(name, first_stats)
        out[name] = {"wall_s": walls[0], "walls_s": walls, "launches": runs_launches[0],
                     "launches_per_run": runs_launches, "peak_bytes": max(peaks),
                     "peaks_bytes": peaks, "counts": counts, "fusion": fusion,
                     "counters": first_stats["counters"], "timers": first_stats["timers"]}
        if profile:
            out[name]["profile"] = profile_run(name, lambda: run(device="cuda",
                                                                 ingested=ingested))
        del ingested
        torch.cuda.empty_cache()
    return out


#: phase 17: warm-up, then this many timed runs of each query each way
BRIDGE_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit


def _bridge_runners(name: str, data, host: dict):
    """(answer check, the boundary runner, a function that puts the inputs on
    the card (set-up) and returns the card runner) of q42 or q93; the
    runners take a stats dict, the boundary runner also a conf."""
    import numpy as np

    from auron_tpu_torch.models import tpcds

    if name == "q42":
        want = _oracle("q42", data)

        def check(got):
            assert got["brand"].shape == (10,) and np.isfinite(got["rev"]).all(), got
            assert np.array_equal(got["brand"], want["brand"]), (got["brand"], want["brand"])
            _assert_close(got["rev"], want["rev"])

        def on_card():
            ingested = tpcds.ingest_q42(data, device="cuda")
            return lambda st: tpcds.run_q42_class(device="cuda", ingested=ingested, stats=st)

        return check, lambda st, conf=None: tpcds.run_q42_bridge(
            device="cuda", host=host, conf=conf, stats=st), on_card
    want = _oracle("q93", data)

    def on_card():
        ingested = tpcds.ingest_q93(data, 4, device="cuda")
        return lambda st: tpcds.run_q93_class(device="cuda", ingested=ingested, stats=st)

    return (lambda got: _assert_q93(got, want),
            lambda st, conf=None: tpcds.run_q93_bridge(device="cuda", host=host, conf=conf,
                                                       stats=st), on_card)


def run_bridge_phase(data, profile: bool = False) -> dict:
    """Phase 17: q42 and q93 (4 map x 4 reduce) through the host boundary
    (``run_q42_bridge`` / ``run_q93_bridge``: host Arrow batches handed over
    as C streams, ingested by the ffi_readers, answers out through
    ipc_writer blocks or next_batch_c; a host clock around all of it), then
    with their inputs on the card (the device runners; ingest is set-up): a
    warm-up each way, then BRIDGE_TIMED_RUNS timed runs each, every answer
    equal to its oracle, and each boundary run launching K1/K3 exactly as
    its card run (the same batches). The boundary runs come first, so their
    peak device memory holds no resident inputs."""
    import torch

    from auron_tpu_torch.models import tpcds

    out = {}
    t0 = time.perf_counter()
    hosts = {"q42": tpcds.host_q42(data), "q93": tpcds.host_q93(data, 4)}
    host_bytes = {k: sum(sum(b.nbytes for c in hb.columns for b in c.buffers if b is not None)
                         for part in ([v["q42_fact"], v["q42_item"]] if k == "q42"
                                      else v["fact"] + [v["cust"]]) for hb in part)
                  for k, v in hosts.items()}
    print(f"host Arrow batches of q42 and q93 (set-up) in {time.perf_counter() - t0:.2f} s: "
          f"{host_bytes['q42'] / 1e6:.1f} MB and {host_bytes['q93'] / 1e6:.1f} MB of buffers",
          flush=True)
    for name in ("q42", "q93"):
        check, bridge, on_card = _bridge_runners(name, data, hosts[name])
        res = {"host_bytes": host_bytes[name]}
        modes = {"bridge": bridge, "card": None}
        if name == "q42":  # the key's off setting: one more host copy of every plane
            modes = {"bridge": bridge, "bridge_zerocopy_off":
                     lambda st: bridge(st, {"exec.scan.zerocopy": "off"}), "card": None}
        for mode, run in modes.items():
            run = run or on_card()
            torch.cuda.synchronize()
            check(run({}))  # warm-up
            runs = []
            for _ in range(BRIDGE_TIMED_RUNS):
                _reset_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                st: dict = {}
                t0 = time.perf_counter()
                got = run(st)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _launches()
                check(got)
                r = {"wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": launches, "stage_s": st.get("stage_s", {})}
                line = (f"{name} ({mode}): wall {wall:.4f} s, K1 {launches['murmur3_pmod']} "
                        f"K3 {launches['bitonic_sort']}, peak "
                        f"{r['peak_bytes'] / 2**30:.3f} GiB")
                if mode != "card":
                    r.update({k: st[k] for k in ("ingest_s", "ingest_bytes", "zerocopy_planes",
                                                 "copied_planes", "egress_s")})
                    r["ingest_gb_per_s"] = st["ingest_bytes"] / st["ingest_s"] / 1e9
                    line += (f", ingest {st['ingest_s']:.4f} s for {st['ingest_bytes']:,} B "
                             f"({r['ingest_gb_per_s']:.2f} GB/s), planes zero-copy "
                             f"{st['zerocopy_planes']} copied {st['copied_planes']}, egress "
                             f"{st['egress_s'] * 1e3:.3f} ms, stages {_fmt_s(r['stage_s'])}")
                print(line + "; equal to the oracle", flush=True)
                runs.append(r)
            res[mode] = {"runs": runs}
            if mode == "bridge" and profile:
                res["profile"] = profile_run(f"{name} (bridge)", lambda: bridge({}))
            del run
        for k in ("murmur3_pmod", "bitonic_sort"):
            card_n = {r["launches"][k] for r in res["card"]["runs"]}
            bridge_n = {r["launches"][k] for r in res["bridge"]["runs"]}
            assert card_n == bridge_n, (name, k, card_n, bridge_n)
        out[name] = res
        torch.cuda.empty_cache()
    return out


#: phase 18: warm-up, then this many timed runs of each query from bytes
PLAN_IR_TIMED_RUNS = 2
#: phase 18: the (K1, K3) launches of each query's timed run
PLAN_IR_LAUNCHES = {"q42": (0, 1), "q93": (24, 0), "q3": (0, 0)}


@contextlib.contextmanager
def _recording_tasks(record: list):
    """Record every ``TaskDefinition`` message ``plan/builders.task`` makes
    inside the block (the runners build their tasks through it)."""
    from auron_tpu_torch.plan import builders

    real = builders.task

    def task(*args, **kwargs):
        record.append(real(*args, **kwargs))
        return record[-1]

    builders.task = task
    try:
        yield
    finally:
        builders.task = real


def _plan_ir_line(name: str, mode: str, wall: float, st: dict, launches: dict) -> str:
    return (f"{name} ({mode}): wall {wall:.4f} s, task_bytes {st['task_bytes']:,} in "
            f"{st['n_tasks']} task(s), decode_s {st['decode_s'] * 1e3:.3f} ms, plan_s "
            f"{st['plan_s'] * 1e3:.3f} ms, K1 {launches['murmur3_pmod']} K3 "
            f"{launches['bitonic_sort']}")


def _run_plan_ir_bytes(data, fact) -> dict:
    """Phase 18 (2): q42, q93 and q3 from TaskDefinition bytes through
    ``call_native`` in this process; q42 also from its prebuilt exec tree
    (the planner's tree, planned outside the timed run) in turns, so the
    bytes' decode and planning show against the same tree."""
    import torch

    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.runtime.task import TaskRuntime

    q42_in = tpcds.ingest_q42(data, device="cuda")
    q42_want = _oracle("q42", data)

    def q42_check(got):
        assert got["brand"].shape == (10,) and all(math.isfinite(x) for x in got["rev"]), got
        assert _np_equal(got["brand"], q42_want["brand"]), (got["brand"], q42_want["brand"])
        _assert_close(got["rev"], q42_want["rev"])

    def q42_tree(st):
        rt = TaskRuntime(tree, resources=dict(q42_in), device="cuda")
        try:
            batches = list(rt)
        finally:
            snap = rt.finalize()
        tpcds.add_timers(st, snap)
        out = tpcds.collect(batches)
        return {"brand": out["brand"], "rev": out["rev"]}

    tree = tpcds.q42_exec_tree()
    q93_in = tpcds.ingest_q93(data, 4, device="cuda", fact=fact)
    q3_in = tpcds.ingest_q3(data, 4, device="cuda", fact=fact)
    q93_want, q3_want = _oracle("q93", data), _oracle("q3", data)
    paths = {
        ("q42", "bytes"): (lambda st: tpcds.run_q42_class(device="cuda", ingested=q42_in,
                                                          stats=st), q42_check),
        ("q42", "tree"): (q42_tree, q42_check),
        ("q93", "bytes"): (lambda st: tpcds.run_q93_class(device="cuda", ingested=q93_in,
                                                          stats=st),
                           lambda got: _assert_q93(got, q93_want)),
        ("q3", "bytes"): (lambda st: tpcds.run_q3_class(device="cuda", ingested=q3_in,
                                                        stats=st),
                          lambda got: _assert_q3(got, q3_want)),
    }
    out: dict = {}
    record: list = []
    for (name, mode), (run, check) in paths.items():
        if name == "q42" and mode == "bytes":
            with _recording_sorts(record):
                check(run({}))  # warm-up; its kernel sorts are checked below
        else:
            check(run({}))
    order = [("q42", "tree"), ("q42", "bytes"), ("q42", "bytes"), ("q42", "tree"),
             ("q93", "bytes"), ("q93", "bytes"), ("q3", "bytes"), ("q3", "bytes")]
    for name, mode in order:
        run, check = paths[(name, mode)]
        _reset_launches()
        torch.cuda.synchronize()
        st: dict = {}
        t0 = time.perf_counter()
        got = run(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        check(got)
        st.setdefault("task_bytes", 0)
        st.setdefault("decode_s", 0.0)
        st.setdefault("plan_s", 0.0)
        st["n_tasks"] = {"q42": 1, "q93": 8, "q3": 8}[name] if mode == "bytes" else 0
        r = {"wall_s": wall, "launches": launches, **{k: st[k] for k in (
            "task_bytes", "decode_s", "plan_s", "n_tasks")}}
        want = PLAN_IR_LAUNCHES[name]
        assert (launches["murmur3_pmod"], launches["bitonic_sort"]) == want, (name, launches)
        print(_plan_ir_line(name, mode, wall, st, launches) + "; equal to the oracle",
              flush=True)
        out.setdefault(f"{name} ({mode})", {"runs": []})["runs"].append(r)
    out["sort_checks"] = check_sorts("q42 (plan IR)", record)
    return out


#: phase 18's C host: q42 through one harness process, q93 through the
#: library (a warm-up, then timed runs), q93 with each task in its own
#: process at 2 x 2 (every process pays the engine's start)
C_HOST_PROCESS_RUNS = 1
C_HOST_LIBRARY_RUNS = 1
C_HOST_PROCESS_TASKS = 2


def _run_c_host(data) -> dict:
    """Phase 18 (3): the port's C ABI built from csrc/, then q42 through one
    bridge_harness process per run, q93 (4 x 4) through the library loaded
    in this process with ctypes (warm-up, timed runs), and q93 once with
    each task in its own harness process (C_HOST_PROCESS_TASKS map and as
    many reduce tasks)."""
    import torch

    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    so, harness = cuda_build.build_bridge()
    build_s = time.perf_counter() - t0
    print(f"built the C ABI ({os.path.basename(so)}, {os.path.basename(harness)}) in "
          f"{build_s:.2f} s", flush=True)
    out: dict = {"build_s": build_s}
    host42, host93 = tpcds.host_q42(data), tpcds.host_q93(data, 4)
    want42, want93 = _oracle("q42", data), _oracle("q93", data)
    for i in range(C_HOST_PROCESS_RUNS):
        st: dict = {}
        t0 = time.perf_counter()
        got = tpcds.run_q42_c_abi(device="cuda", host=host42, stats=st)
        wall = time.perf_counter() - t0
        assert _np_equal(got["brand"], want42["brand"]), (got, want42)
        _assert_close(got["rev"], want42["rev"])
        (proc,) = st["processes"]
        assert (st["launches"]["murmur3_pmod"], st["launches"]["bitonic_sort"]) == \
            PLAN_IR_LAUNCHES["q42"], st["launches"]
        print(f"q42 (C host, process {i}): wall {wall:.4f} s, harness process "
              f"{proc['process_s']:.4f} s = start with imports and CUDA init "
              f"{proc['init_s']:.4f} s + resources {proc['resources_s']:.4f} s + task "
              f"{proc['task_s']:.4f} s (+ exec and exit "
              f"{proc['process_s'] - proc['init_s'] - proc['resources_s'] - proc['task_s']:.4f}"
              f" s), IPC resources {st['resource_bytes']:,} B, task_bytes {st['task_bytes']}, "
              f"decode_s {st['decode_s'] * 1e3:.3f} ms, plan_s {st['plan_s'] * 1e3:.3f} ms, "
              f"K1 {st['launches']['murmur3_pmod']} K3 {st['launches']['bitonic_sort']} (the "
              f"process's counts); equal to the oracle", flush=True)
        out.setdefault("q42 (C host)", {"runs": []})["runs"].append(
            {"wall_s": wall, **proc, "resource_bytes": st["resource_bytes"],
             "launches": st["launches"], **{k: st[k] for k in ("task_bytes", "decode_s",
                                                                "plan_s")}})
    torch.cuda.synchronize()
    for i in range(1 + C_HOST_LIBRARY_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        st = {}
        t0 = time.perf_counter()
        got = tpcds.run_q93_c_abi(device="cuda", host=host93, via="library", stats=st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        _assert_q93(got, want93)
        assert (launches["murmur3_pmod"], launches["bitonic_sort"]) == \
            PLAN_IR_LAUNCHES["q93"], launches
        label = "warm-up" if i == 0 else f"run {i - 1}"
        print(f"q93 (C host, library, {label}): wall {wall:.4f} s (map {st['map_s']:.4f} s, "
              f"reduce {st['reduce_s']:.4f} s), IPC and manifest resources "
              f"{st['resource_bytes']:,} B, task_bytes {st['task_bytes']:,} in 8 tasks, "
              f"decode_s {st['decode_s'] * 1e3:.3f} ms, plan_s {st['plan_s'] * 1e3:.3f} ms, "
              f"K1 {launches['murmur3_pmod']} K3 {launches['bitonic_sort']}; equal to the "
              f"oracle", flush=True)
        if i:
            out.setdefault("q93 (C host, library)", {"runs": []})["runs"].append(
                {"wall_s": wall, "launches": launches, **{k: st[k] for k in (
                    "map_s", "reduce_s", "resource_bytes", "task_bytes", "decode_s",
                    "plan_s")}})
    # q93 once more with every task in its own harness process: the map
    # tasks at once, then the reduce tasks through shuffle:q93_ex0 manifests
    n = C_HOST_PROCESS_TASKS
    host = tpcds.host_q93(data, n)
    st = {}
    t0 = time.perf_counter()
    got = tpcds.run_q93_c_abi(device="cuda", host=host, n_map=n, n_reduce=n, via="process",
                              stats=st)
    wall = time.perf_counter() - t0
    _assert_q93(got, want93)
    # K1 once a fact batch (22 batches in 2 partitions at SF 8)
    assert (st["launches"]["murmur3_pmod"], st["launches"]["bitonic_sort"]) == \
        (sum(len(p) for p in host["fact"]), 0), st["launches"]
    procs = st["processes"]
    print(f"q93 (C host, processes): wall {wall:.4f} s (map {st['map_s']:.4f} s, reduce "
          f"{st['reduce_s']:.4f} s), {len(procs)} harness processes "
          f"{min(p['process_s'] for p in procs):.4f}-{max(p['process_s'] for p in procs):.4f} s "
          f"each, start with imports and CUDA init "
          f"{min(p['init_s'] for p in procs):.4f}-{max(p['init_s'] for p in procs):.4f} s, tasks "
          f"{min(p['task_s'] for p in procs):.4f}-{max(p['task_s'] for p in procs):.4f} s, "
          f"IPC and manifest resources {st['resource_bytes']:,} B, K1 "
          f"{st['launches']['murmur3_pmod']} K3 {st['launches']['bitonic_sort']} (the "
          f"processes' counts); equal to the oracle", flush=True)
    out["q93 (C host, processes)"] = {"runs": [
        {"wall_s": wall, "launches": st["launches"], "processes": procs, **{k: st[k] for k in (
            "map_s", "reduce_s", "resource_bytes", "task_bytes", "decode_s", "plan_s")}}]}
    return out


@contextlib.contextmanager
def _without_pyarrow():
    """Phases 18 and 19 prove that their paths need no pyarrow: the
    shuffle's general codec is ``pa.Codec``'s, so they run with
    ``exec.shuffle.encoding.fallback.codec`` = none (by its environment key,
    which every Configuration and every harness process reads). Where an
    earlier phase's lz4 shuffle has loaded pyarrow, the phase runs with it
    blocked in ``sys.modules``: any import of it raises, so the proof holds
    in the whole script too."""
    from auron_tpu_torch.utils.config import SHUFFLE_ENCODING_FALLBACK, env_key_for

    key = env_key_for(SHUFFLE_ENCODING_FALLBACK.key)
    prev = os.environ.get(key)
    os.environ[key] = "none"
    held = {m: mod for m, mod in sys.modules.items()
            if mod is not None and m.split(".")[0] == "pyarrow"}
    sys.modules.update(dict.fromkeys(held))
    if held:
        print(f"pyarrow ({len(held)} modules, loaded by an earlier phase) blocked for the "
              "phase", flush=True)
    try:
        yield
    finally:
        sys.modules.update(held)
        if prev is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prev


def _loaded(*prefixes) -> list:
    """The modules under ``prefixes`` that are loaded (not blocked)."""
    return sorted(m for m, mod in sys.modules.items()
                  if mod is not None and any(m == p or m.startswith(p + ".") for p in prefixes))


def run_plan_ir_phase(data, fact, seed: int, kernels_checked: bool) -> dict:
    """Phase 18: the plan IR without google.protobuf and the C host. (1)
    every TaskDefinition the phase makes decodes and re-encodes to the same
    bytes in the port's codec; (2) q42, q93 and q3 from bytes in this
    process (``_run_plan_ir_bytes``); (3) the C host (``_run_c_host``);
    at the end google.protobuf is not loaded. Without phase 3
    (``kernels_checked`` False) K1 is held against its plain version here,
    as phase 3 does."""
    from auron_tpu_torch import proto as pb

    if not kernels_checked:
        check_partition_kernel(seed)
    tasks: list = []
    with _recording_tasks(tasks), _without_pyarrow():
        out = _run_plan_ir_bytes(data, fact)
        out["c_host"] = _run_c_host(data)
    t0 = time.perf_counter()
    for t in tasks:
        b = t.SerializeToString()
        assert pb.TaskDefinition.FromString(b).SerializeToString() == b, "codec round trip"
    print(f"codec: {len(tasks)} TaskDefinitions decode and re-encode to the same bytes "
          f"({sum(len(t.SerializeToString()) for t in tasks):,} B, "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)
    loaded = _loaded("google.protobuf")
    assert not loaded, f"google.protobuf was imported: {loaded}"
    print("google.protobuf is not in sys.modules", flush=True)
    out["codec_tasks"] = len(tasks)
    return out


CONVERT_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit
#: (K1, K2, K3) launches of a converted run, as phase 18's runs from bytes
#: (q42 K3 once, q93 K1 24: 6 batches x 4 map tasks) and q93-mesh (K1 and K2
#: once per source shard)
CONVERT_LAUNCHES = {"q42": (0, 0, 1), "q93": (24, 0, 0), "q3": (0, 0, 0),
                    "q93-mesh": (4, 4, 0)}


def _task_summary(st: dict) -> str:
    tasks = st.get("tasks", [])
    dec = [t["decode_s"] * 1e3 for t in tasks]
    pln = [t["plan_s"] * 1e3 for t in tasks]
    return (f"{len(tasks)} task(s), decode_s {min(dec):.3f}-{max(dec):.3f} ms, plan_s "
            f"{min(pln):.3f}-{max(pln):.3f} ms") if tasks else "no task"


def _convert_record(wall: float, st: dict, launches: dict) -> dict:
    return {"wall_s": wall, "launches": launches, "convert_s": st.get("convert_s"),
            "response_bytes": st.get("response_bytes"), "stages": st.get("stages"),
            "stage_s": st.get("stage_s"), "partition_rows": st.get("partition_rows"),
            "tasks": [{k: t[k] for k in ("stage", "partition", "wall_s", "decode_s", "plan_s",
                                         "task_bytes")} for t in st.get("tasks", [])]}


def _run_convert_classes(data, fact) -> dict:
    """Phase 19 (1-2): q42, q93 (4 x 4) and q3 (4 x 4) from their host-plan
    JSON through ``convert_plan_json`` and the response's stages, and the
    converted q93 segment under ``MeshQueryDriver`` (mode mesh, P = 4)."""
    import torch

    from auron_tpu_torch.models import tpcds

    q42_in = tpcds.ingest_q42(data, device="cuda")
    q93_in = tpcds.ingest_q93(data, 4, device="cuda", fact=fact)
    q3_in = tpcds.ingest_q3(data, 4, device="cuda", fact=fact)
    q42_want, q3_want = _oracle("q42", data), _oracle("q3", data)
    q93_want = _oracle("q93", data)

    def q42_check(got):
        assert got["brand"].shape == (10,) and all(math.isfinite(x) for x in got["rev"]), got
        assert _np_equal(got["brand"], q42_want["brand"]), (got["brand"], q42_want["brand"])
        _assert_close(got["rev"], q42_want["rev"])

    paths = {
        "q42": (lambda st: tpcds.run_q42_converted(device="cuda", ingested=q42_in, stats=st),
                q42_check),
        "q93": (lambda st: tpcds.run_q93_converted(device="cuda", ingested=q93_in, stats=st),
                lambda got: _assert_q93(got, q93_want)),
        "q3": (lambda st: tpcds.run_q3_converted(device="cuda", ingested=q3_in, stats=st),
               lambda got: _assert_q3(got, q3_want)),
        "q93-mesh": (lambda st: tpcds.run_q93_converted_mesh(
            device="cuda", conf={"exchange.mode": "mesh"}, ingested=q93_in, stats=st),
            lambda got: _assert_q93(got, q93_want)),
    }
    out: dict = {"sort_checks": []}
    for name, (run, check) in paths.items():
        shapes: list = []
        record: list = []
        with _recording_kernel_sorts(shapes), _recording_sorts(record):
            check(run({}))  # warm-up; its kernel sorts are checked here
        out["sort_checks"] += check_sorts(f"{name} (converted)", record)
        del record
        for i in range(CONVERT_TIMED_RUNS):
            _reset_launches()
            torch.cuda.synchronize()
            st: dict = {}
            t0 = time.perf_counter()
            got = run(st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            check(got)
            assert (launches["murmur3_pmod"], launches["partition_histogram"],
                    launches["bitonic_sort"]) == CONVERT_LAUNCHES[name], (name, launches)
            _assert_planned_launches(f"{name} (converted)", shapes, launches,
                                     sorts=name == "q42")
            if name == "q93-mesh":
                assert st["mode"] == "mesh", st["mode"]
                detail = (f"map {st['map_s']:.4f} s, exchange {st['exchange_s']:.4f} s, "
                          f"reduce {st['reduce_s']:.4f} s, routing {st['routing']}")
            else:
                detail = (f"stages {st['stages']} ({', '.join(f'{w:.4f}' for w in st['stage_s'])}"
                          f" s), {_task_summary(st)}")
            print(f"{name} (converted, run {i}): wall {wall:.4f} s, convert_s "
                  f"{st['convert_s'] * 1e3:.3f} ms, response {st['response_bytes']:,} B, "
                  f"{detail}, K1 {launches['murmur3_pmod']} K2 "
                  f"{launches['partition_histogram']} K3 {launches['bitonic_sort']} K4 "
                  f"{launches['bitonic_merge']}; equal to the oracle", flush=True)
            out.setdefault(f"{name} (converted)", {"runs": []})["runs"].append(
                _convert_record(wall, st, launches))
    assert out["sort_checks"], "q42's sort was not checked"
    return out


def _run_range_sort(data, fact) -> dict:
    """Phase 19 (3): the range-partitioned global sort of the projected fact
    (4 map x 4 reduce) from its host plan; the warm-up's kernel sorts held
    against the plain network on the card, bit for bit."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_range_sort(data, 4, device="cuda", fact=fact)
    t0 = time.perf_counter()
    want = ORACLES["range sort"] = tpcds.range_sort_oracle(data, 4, device="cuda")
    print(f"range sort oracle (the fact's 4 columns lexsorted on the card by library "
          f"sorts) in {time.perf_counter() - t0:.2f} s; bounds "
          f"{tpcds.range_sort_bounds(data, 4)}", flush=True)

    def check(parts):
        t0 = time.perf_counter()
        bad = tpcds.range_sort_mismatch(parts, want, device="cuda")
        assert bad is None, bad
        return time.perf_counter() - t0

    record: list = []
    shapes: list = []
    with _recording_sorts(record), _recording_kernel_sorts(shapes):
        check(tpcds.run_range_sort_converted(data, device="cuda", ingested=ingested))
    # the recorded operands are checked and freed before the timed runs,
    # whose peak they would otherwise join
    out: dict = {"sort_shapes": [list(s) for s in shapes],
                 "sort_checks": check_sorts("range sort (converted)", record)}
    del record
    for i in range(CONVERT_TIMED_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st: dict = {}
        t0 = time.perf_counter()
        parts = tpcds.run_range_sort_converted(data, device="cuda", ingested=ingested, stats=st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        check_s = check(parts)
        del parts
        assert launches["murmur3_pmod"] == 0 and launches["bitonic_sort"] > 0, launches
        _assert_planned_launches("range sort (converted)", shapes, launches)
        timers = st["timers"]
        pick = {k: v for k, v in timers.items()
                if k.endswith(("sort_time", "compress_time", "decode_time"))}
        print(f"range sort (converted, run {i}): wall {wall:.4f} s (map stage "
              f"{st['stage_s'][0]:.4f} s, reduce stage {st['stage_s'][1]:.4f} s, of it the "
              f"answer's host read {st['collect_s']:.4f} s), convert_s "
              f"{st['convert_s'] * 1e3:.3f} ms, response {st['response_bytes']:,} B, rows per "
              f"partition {st['partition_rows']}, shuffle {st['shuffle_bytes']:,} B, "
              f"{_task_summary(st)}, peak {peak / 2**30:.2f} GiB, K3 "
              f"{launches['bitonic_sort']} K4 {launches['bitonic_merge']}, timers "
              f"{ {k: round(v, 4) for k, v in sorted(pick.items())} }; passes its oracle "
              f"(checked in {check_s:.2f} s)", flush=True)
        out.setdefault("runs", []).append({**_convert_record(wall, st, launches),
                                           "peak_bytes": peak, "timers": pick,
                                           "shuffle_bytes": st["shuffle_bytes"],
                                           "collect_s": st["collect_s"]})
    return out


def _run_convert_c_host(data, fact) -> dict:
    """Phase 19 (4): q93's host plan through one ``bridge_harness --convert``
    process (its response equals the in-process one, namespace replaced),
    then that response's stages through ``libauron_bridge`` loaded in this
    process."""
    import torch

    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.bridge.host import harness_env
    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.ops import cuda_build

    _, harness = cuda_build.build_bridge()
    os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
    plan_path = os.path.join(REPO_DIR, "chiprun_out", "q93_host_plan.json")
    resp_path = os.path.join(REPO_DIR, "chiprun_out", "q93_response.json")
    payload = json.dumps(tpcds.q93_host_plan(4)).encode()
    with open(plan_path, "wb") as f:
        f.write(payload)
    t0 = time.perf_counter()
    # the conversion is host work: the process asks for the CPU, no CUDA init
    r = subprocess.run([harness, "--convert", plan_path, resp_path], env=harness_env("cpu"),
                       capture_output=True, text=True, timeout=300)
    proc_s = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-3000:]
    with open(resp_path, "rb") as f:
        resp = f.read()
    mine = api.convert_plan_json(payload)
    assert tpcds.namespace_free(resp) == tpcds.namespace_free(mine), "harness response"
    print(f"q93 (C host): bridge_harness --convert process {proc_s:.3f} s, response "
          f"{len(resp):,} B, equal to the in-process response (namespace replaced)", flush=True)
    want = _oracle("q93", data)
    q93_in = tpcds.ingest_q93(data, 4, device="cuda", fact=fact)
    out: dict = {"convert_process_s": proc_s, "response_bytes": len(resp)}
    for i in range(1 + CONVERT_TIMED_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        st: dict = {}
        t0 = time.perf_counter()
        got = tpcds.run_q93_converted(device="cuda", ingested=q93_in, stats=st,
                                      response=json.loads(resp), via="library")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        _assert_q93(got, want)
        assert (launches["murmur3_pmod"], launches["bitonic_sort"]) == (24, 0), launches
        label = "warm-up" if i == 0 else f"run {i - 1}"
        print(f"q93 (converted, C library, {label}): wall {wall:.4f} s, stages "
              f"{', '.join(f'{w:.4f}' for w in st['stage_s'])} s, {_task_summary(st)}, K1 "
              f"{launches['murmur3_pmod']}; equal to the oracle", flush=True)
        if i:
            out.setdefault("runs", []).append(_convert_record(wall, st, launches))
    return out


def run_convert_phase(data, fact, seed: int, kernels_checked: bool) -> dict:
    """Phase 19: the host-plan converters. (1-2) q42, q93 and q3 from
    host-plan JSON through ``convert_plan_json`` and the response's stages,
    and the converted q93 segment on the mesh; (3) the range sort; (4) the C
    host's conversion and the library's run of its response. Fails if
    google.protobuf or pyarrow was loaded. Without phase 3
    (``kernels_checked`` False) K1 and K2 are held against their plain
    versions here (K3/K4 at the phase's own sorts)."""
    if not kernels_checked:
        check_partition_kernel(seed)
        check_histogram_kernel(seed)
    with _without_pyarrow():
        out = _run_convert_classes(data, fact)
        out["range sort (converted)"] = _run_range_sort(data, fact)
        out["c_host"] = _run_convert_c_host(data, fact)
        loaded = _loaded("google.protobuf", "pyarrow")
    assert not loaded, f"the conversion path loaded {loaded}"
    print("neither google.protobuf nor pyarrow is in sys.modules (pyarrow blocked where an "
          "earlier phase loaded it)", flush=True)
    return out


#: phase 20: warm-up, then this many timed runs of each read from files
FILES_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit
#: phase 20: (K1, K3) launches of a timed read, as phase 19's converted runs
#: (q93: 6 row groups of 1 << 20 rows in each of 4 map tasks' files)
FILES_LAUNCHES = {"q42": (0, 1), "q93": (24, 0), "q3": (0, 0), "q42 (orc)": (0, 1),
                  "q3 (sorted)": (0, 0)}
#: phase 20: the converted path of phase 19 each read is compared with
FILES_IN_MEMORY = {"q42": "q42", "q93": "q93", "q3": "q3", "q42 (orc)": "q42",
                   "q3 (sorted)": "q3"}


def _read_back(files: list, fmt: str = "parquet"):
    """The part files as one pyarrow table, in task order."""
    import pyarrow as pa

    if fmt == "orc":
        import pyarrow.orc as orc

        return pa.concat_tables([orc.ORCFile(f).read() for f in files])
    import pyarrow.parquet as pq

    # one file each, read as it is (read_table may add a Hive directory's key)
    return pa.concat_tables([pq.ParquetFile(f).read() for f in files])


def _check_written(label: str, got, table, drop: tuple = ()) -> None:
    from auron_tpu_torch.models import tpcds

    bad = tpcds.table_mismatch(got, table, drop)
    assert bad is None, f"{label}: {bad}"


def _egress_ab(fact) -> dict:
    """The sinks' egress (``Batch.to_arrow``: pinned copies and the C data
    interface) against a pyarrow build of each column from ``to_numpy``
    (``tests/torch_arrow.pyarrow_egress``, the tests' reference) over the
    fact's batches on the card, in turns (pyarrow, to_arrow, to_arrow,
    pyarrow), each batch equal both ways."""
    import torch

    sys.path.insert(0, os.path.join(REPO_DIR, "tests"))
    from torch_arrow import pyarrow_egress

    ways = {"pyarrow": pyarrow_egress, "to_arrow": lambda b: b.to_arrow()}
    walls: dict = {k: [] for k in ways}
    for way in ways.values():  # warm-up: imports, first copies
        way(fact[0][0])
    for way in ("pyarrow", "to_arrow", "to_arrow", "pyarrow"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [ways[way](b) for part in fact for b in part]
        walls[way].append(time.perf_counter() - t0)
        if way == "to_arrow" and len(walls[way]) == 1:
            assert all(g.equals(pyarrow_egress(b)) for g, b in
                       zip(got, (b for part in fact for b in part))), "egress differs"
        del got
    print(f"egress of the fact's {sum(len(p) for p in fact)} batches: pyarrow per column "
          f"{', '.join(f'{w:.4f}' for w in walls['pyarrow'])} s, Batch.to_arrow (the sinks') "
          f"{', '.join(f'{w:.4f}' for w in walls['to_arrow'])} s; equal batches", flush=True)
    return walls


def _run_file_writes(data, root: str, fact) -> dict:
    """Phase 20 (1): the four tables as Parquet (the fact from 4 map tasks),
    the fact as ORC, item Hive-partitioned by i_category, each through its
    converted DataWritingCommandExec plan over scans of batches on the card,
    and each read back with pyarrow against the numpy tables."""
    import os

    import numpy as np
    import torch

    from auron_tpu_torch.exec.sink import _hive_escape
    from auron_tpu_torch.models import tpcds

    out: dict = {"parquet": {}, "egress": _egress_ab(fact)}
    torch.cuda.synchronize()
    paths = tpcds.write_tables(data, os.path.join(root, "parquet"), device="cuda", fact=fact,
                               stats=out["parquet"])
    for name, table in tpcds.file_tables(data).items():
        st = out["parquet"][name]
        t0 = time.perf_counter()
        _check_written(f"{name} (parquet)", _read_back(tpcds.part_files(paths[name])), table)
        print(f"write {name} (parquet): wall {st['wall_s']:.4f} s, {len(table):,} rows in "
              f"{len(tpcds.part_files(paths[name]))} file(s), {st['bytes']:,} B, timers "
              f"{ {k: round(v, 4) for k, v in st['timers'].items() if 'Sink' in k} }; read back "
              f"equal to the numpy table in {time.perf_counter() - t0:.2f} s", flush=True)
    st: dict = {}
    t0 = time.perf_counter()
    orc_dir = tpcds.write_table(data.store_sales, os.path.join(root, "orc"), "cuda", fmt="orc",
                                batches=fact, stats=st)
    st["wall_s"], st["bytes"] = time.perf_counter() - t0, tpcds.dir_bytes(orc_dir)
    _check_written("store_sales (orc)", _read_back(tpcds.part_files(orc_dir, "orc"), "orc"),
                   data.store_sales)
    print(f"write store_sales (orc): wall {st['wall_s']:.4f} s, {st['bytes']:,} B; read back "
          f"equal to the numpy table", flush=True)
    out["orc"] = st
    st = {}
    t0 = time.perf_counter()
    hive = tpcds.write_table(data.item, os.path.join(root, "item_hive"), "cuda",
                             partition_by=["i_category"], stats=st)
    st["wall_s"] = time.perf_counter() - t0
    cats, counts = np.unique(data.item.columns["i_category"].astype(str), return_counts=True)
    want_dirs = {f"i_category={_hive_escape(c)}": (c, n) for c, n in zip(cats, counts)}
    assert sorted(os.listdir(hive)) == sorted(want_dirs), (os.listdir(hive), want_dirs)
    for d, (c, n) in want_dirs.items():
        mask = data.item.columns["i_category"] == c
        sub = tpcds.Table(data.item.schema, {k: v[mask] for k, v in data.item.columns.items()},
                          {k: v[mask] for k, v in data.item.valid.items()})
        got = _read_back(tpcds.part_files(os.path.join(hive, d)))
        assert got.num_rows == n, (d, got.num_rows, n)
        _check_written(f"item ({d})", got, sub, drop=("i_category",))
    assert st["counters"]["ParquetSinkExec.partitions_written"] == len(want_dirs), st
    print(f"write item (hive by i_category): wall {st['wall_s']:.4f} s, directories "
          f"{sorted(want_dirs)}, rows {counts.tolist()}, equal to numpy's", flush=True)
    out["item_hive"] = {"wall_s": st["wall_s"], "dirs": sorted(want_dirs),
                        "rows": counts.tolist()}
    out["paths"] = paths
    out["orc_dir"] = orc_dir
    return out


def _run_sorted_write(data, root: str, fact) -> dict:
    """Phase 20 (2): ``df.orderBy(date, item).write.parquet``, the range
    sort under a DataWritingCommandExec (4 map x 4 reduce); its kernel
    sorts held against the plain network on the card, bit for bit, and its
    launches against ``sort_plan``; the files read back against the range
    sort's oracle."""
    import os

    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_range_sort(data, 4, device="cuda", fact=fact)
    path = os.path.join(root, "sorted")
    record: list = []
    shapes: list = []
    _reset_launches()
    torch.cuda.synchronize()
    st: dict = {}
    t0 = time.perf_counter()
    with _recording_sorts(record), _recording_kernel_sorts(shapes):
        files = tpcds.run_sorted_write(data, path, device="cuda", ingested=ingested, stats=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    _assert_planned_launches("sorted write", shapes, launches)
    assert launches["bitonic_sort"] == 4, launches
    checks = check_sorts("sorted write", record)
    del record
    import pyarrow.parquet as pq

    row_groups = [pq.ParquetFile(f).metadata.num_row_groups for f in files]
    want = ORACLES.get("range sort") or tpcds.range_sort_oracle(data, 4, device="cuda")
    parts = []
    for f in files:
        t = pq.ParquetFile(f).read()
        part = {}
        for n in t.column_names:
            c = t.column(n)
            part[f"{n}_valid"] = c.is_valid().to_numpy(zero_copy_only=False)
            part[n] = c.fill_null(0).to_numpy()
        parts.append(part)
    bad = tpcds.range_sort_mismatch(parts, want, device="cuda")
    assert bad is None, f"sorted write: {bad}"
    print(f"sorted write: wall {wall:.4f} s (its sort operands recorded; stages "
          f"{', '.join(f'{w:.4f}' for w in st['stage_s'])} s), {len(files)} files of row groups "
          f"{row_groups}, {tpcds.dir_bytes(path):,} B, K3 {launches['bitonic_sort']} K4 "
          f"{launches['bitonic_merge']} as sort_plan lists, read back equal to the range sort's "
          f"oracle", flush=True)
    return {"wall_s": wall, "stage_s": st["stage_s"], "row_groups": row_groups,
            "bytes": tpcds.dir_bytes(path), "launches": launches, "sort_checks": checks,
            "sort_shapes": [list(s) for s in shapes], "path": path}


def _run_file_reads(data, written: dict, sorted_path: str, sorted_groups: int,
                    convert: dict | None) -> dict:
    """Phase 20 (3): q42, q93 and q3 from the Parquet files, q42 from the
    ORC fact, q3 over the sorted files under its pushed November filter;
    each a warm-up, then timed runs, every answer equal to its oracle."""
    import torch

    from auron_tpu_torch.columnar import batch as batch_mod
    from auron_tpu_torch.models import tpcds

    paths = written["paths"]
    orc_paths = {**paths, "store_sales": written["orc_dir"]}
    sorted_paths = {**paths, "store_sales": sorted_path}
    nov = [tpcds.month_filter(data)]
    q42_want, q3_want = _oracle("q42", data), _oracle("q3", data)
    q93_want = _oracle("q93", data)

    def q42_check(got):
        assert got["brand"].shape == (10,) and all(math.isfinite(x) for x in got["rev"]), got
        assert _np_equal(got["brand"], q42_want["brand"]), (got["brand"], q42_want["brand"])
        _assert_close(got["rev"], q42_want["rev"])

    reads = {
        "q42": (lambda st: tpcds.run_q42_files(paths, "cuda", stats=st), q42_check),
        "q93": (lambda st: tpcds.run_q93_files(paths, device="cuda", stats=st),
                lambda got: _assert_q93(got, q93_want)),
        "q3": (lambda st: tpcds.run_q3_files(paths, device="cuda", stats=st),
               lambda got: _assert_q3(got, q3_want)),
        "q42 (orc)": (lambda st: tpcds.run_q42_files(orc_paths, "cuda", stats=st,
                                                     fact_fmt="orc"), q42_check),
        "q3 (sorted)": (lambda st: tpcds.run_q3_files(
            sorted_paths, device="cuda", stats=st, fact_schema=tpcds.RANGE_SORT_SCHEMA,
            fact_filters=nov), lambda got: _assert_q3(got, q3_want)),
    }
    out: dict = {"sort_checks": []}
    for name, (run, check) in reads.items():
        record: list = []
        with _recording_sorts(record):
            check(run({}))  # warm-up; its kernel sorts are checked here
        out["sort_checks"] += check_sorts(f"{name} (files)", record)
        del record
        mem = (convert or {}).get(f"{FILES_IN_MEMORY[name]} (converted)")
        mem_walls = [r["wall_s"] for r in mem["runs"]] if mem else None
        mem_txt = ("not run" if mem_walls is None
                   else ", ".join(f"{w:.4f}" for w in mem_walls) + " s")
        for i in range(FILES_TIMED_RUNS):
            _reset_launches()
            batch_mod.reset_ingest_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st: dict = {}
            t0 = time.perf_counter()
            got = run(st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            ingest = batch_mod.ingest_stats()
            check(got)
            assert (launches["murmur3_pmod"], launches["bitonic_sort"]) == \
                FILES_LAUNCHES[name], (name, launches)
            scan = {k.split(".", 1)[1]: v for k, v in st["counters"].items()
                    if k.split(".")[0] in ("ParquetScanExec", "OrcScanExec")}
            timers = {k: v for k, v in st["timers"].items()
                      if k.split(".")[0] in ("ParquetScanExec", "OrcScanExec")}
            pruned = ""
            if name == "q3 (sorted)":
                assert scan.get("row_groups_pruned", 0) > 0, scan
                pruned = (f", {scan['row_groups_pruned']} of the sorted files' "
                          f"{sorted_groups} row groups pruned by their statistics")
            print(f"{name} (files, run {i}): wall {wall:.4f} s (in memory, phase 19: "
                  f"{mem_txt}){pruned}, stages "
                  f"{', '.join(f'{w:.4f}' for w in st['stage_s'])} s, scan timers "
                  f"{ {k: round(v, 4) for k, v in sorted(timers.items())} }, scan counters "
                  f"{scan}, ingest {ingest['ingest_bytes']:,} B in {ingest['ingest_s']:.4f} s "
                  f"({ingest['zerocopy_planes']} zero-copy, {ingest['copied_planes']} copied "
                  f"planes), peak {peak / 2**30:.2f} GiB, K1 {launches['murmur3_pmod']} K3 "
                  f"{launches['bitonic_sort']} K4 {launches['bitonic_merge']}; equal to the "
                  f"oracle", flush=True)
            out.setdefault(name, {"runs": [], "in_memory_wall_s": mem_walls})["runs"].append(
                {"wall_s": wall, "launches": launches, "stage_s": st["stage_s"],
                 "scan_timers": timers, "scan_counters": scan, "ingest": ingest,
                 "peak_bytes": peak})
    assert out["sort_checks"], "q42's sort was not checked"
    return out


def run_files_phase(data, seed: int, kernels_checked: bool, convert: dict | None) -> dict:
    """Phase 20: the Parquet and ORC scans and sinks. Writes the tables into
    a temporary directory on local disk (removed at the end), then reads
    them through Spark-shaped FileSourceScanExec host plans. Needs pyarrow
    with pyarrow.orc. Without phase 3 (``kernels_checked`` False) K1 and K2
    are held against their plain versions here."""
    import shutil
    import tempfile

    import torch

    try:
        import pyarrow.orc  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"phase 20 needs pyarrow.orc (the ORC sink and scan): {e}") from e
    from auron_tpu_torch.models import tpcds

    if not kernels_checked:
        check_partition_kernel(seed)
        check_histogram_kernel(seed)
    root = tempfile.mkdtemp(prefix="auron_files_")
    try:
        t0 = time.perf_counter()
        fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
        torch.cuda.synchronize()
        print(f"fact table in 4 partitions on the card in {time.perf_counter() - t0:.2f} s; "
              f"files under {root}", flush=True)
        out = {"writes": _run_file_writes(data, root, fact)}
        out["sorted write"] = _run_sorted_write(data, root, fact)
        del fact
        out["reads"] = _run_file_reads(data, out["writes"], out["sorted write"]["path"],
                                       sum(out["sorted write"]["row_groups"]), convert)
        out["bytes_written"] = tpcds.dir_bytes(root)
        print(f"phase 20 wrote {out['bytes_written']:,} B of files", flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: phase 21: timed runs of the customer-basket class
BASKET_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit


def _pyarrow_of(hb):
    """A host Arrow batch read by pyarrow through the C data interface."""
    import ctypes

    import pyarrow as pa

    from auron_tpu_torch.columnar import arrow_c

    arr, sch = arrow_c.ArrowArray(), arrow_c.ArrowSchema()
    arrow_c.export_batch(hb, ctypes.addressof(arr), ctypes.addressof(sch))
    return pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))


def run_collect_phase(data, seed: int, kernels_checked: bool) -> dict:
    """Phase 21: the customer-basket class at the phases' scale, 4 map x 4
    reduce: a warm-up (its kernel sorts recorded and held against the plain
    network on the card), then BASKET_TIMED_RUNS timed runs, each answer
    equal to the oracle, K1 and K3 launched (K4 too where a reduce task's
    sort passes one cluster) as ``sort_plan`` lists; the answer through the
    C data interface into pyarrow. Without phase 3 (``kernels_checked``
    False) K1 is held against its plain version here."""
    import torch

    from auron_tpu_torch.models import tpcds

    from concurrent.futures import ThreadPoolExecutor

    if not kernels_checked:
        check_partition_kernel(seed)

    def oracle():
        t0 = time.perf_counter()
        return tpcds.basket_class_oracle(data), time.perf_counter() - t0

    # the host oracle in a thread beside the set-up and the warm-up (no
    # timed run overlaps it)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(oracle)
        t0 = time.perf_counter()
        ingested = tpcds.ingest_q3(data, 4, device="cuda")
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        sorts: list = []
        shapes: list = []
        t0 = time.perf_counter()
        with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
            answers = [tpcds.run_basket_class(device="cuda", ingested=ingested)]
        t_warm = time.perf_counter() - t0
        sort_checks = check_sorts("basket", sorts)
        del sorts
        want, t_oracle = pending.result()
    print(f"basket class: inputs on the card in {t_ingest:.2f} s, oracle in {t_oracle:.2f} s, "
          f"warm-up {t_warm:.2f} s", flush=True)
    runs = []
    for i in range(BASKET_TIMED_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st: dict = {}
        t0 = time.perf_counter()
        answers.append(tpcds.run_basket_class(device="cuda", ingested=ingested, stats=st))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        _assert_planned_launches("basket", shapes, launches)
        _assert_must_launch("basket", launches, ("murmur3_pmod", "bitonic_sort"))
        timers = st["timers"]
        picked = {k: timers.get(k, 0.0) for k in (
            "HashAggExec.elapsed_compute", "ShuffleWriterExec.compress_time",
            "IpcReaderExec.decode_time", "SortExec.sort_time")}
        print(f"basket (run {i}): wall {wall:.4f} s (map {st['map_s']:.4f} s, reduce "
              f"{st['reduce_s']:.4f} s, top {st['top_s']:.4f} s, egress {st['egress_s']:.4f} "
              f"s), shuffle bytes written {st['shuffle_bytes']:,}, "
              + ", ".join(f"{k} {v:.4f} s" for k, v in picked.items())
              + f", kernel sorts (NP, P) {shapes}, launches {launches}, peak device memory "
              f"{peak / 2**30:.3f} GiB, {_from_bytes(st)}", flush=True)
        _print_timers(f"basket (run {i})", st)
        runs.append({"wall_s": wall, "launches": launches, "peak_bytes": peak,
                     **{k: st[k] for k in ("map_s", "reduce_s", "top_s", "egress_s",
                                           "shuffle_bytes")},
                     "timers_s": picked, "counters": st["counters"]})
    for hb in answers:
        bad = tpcds.basket_mismatch(hb.to_pydict(), want)
        assert bad is None, ("basket", bad)
    rb = _pyarrow_of(answers[-1])
    assert [c.fmt for c in answers[-1].columns] == ["l", "+s", "+m", "+l"], \
        [c.fmt for c in answers[-1].columns]
    bad = tpcds.basket_mismatch(rb.to_pydict(), want)
    assert bad is None, ("basket through pyarrow", bad)
    print(f"basket: {len(want['ss_customer_sk'])} rows equal to the oracle in every run "
          f"(first key {want['ss_customer_sk'][0]}, its sizes {want['sizes'][0]}); read back "
          f"in pyarrow as {rb.schema.types}", flush=True)
    del ingested
    return {"runs": runs, "sort_shapes": shapes, "sort_checks": sort_checks,
            "ingest_s": t_ingest, "oracle_s": t_oracle, "warm_s": t_warm}


#: phase 22: (label, class, conf, K1 launches of a timed run) of the codec
#: runs: q93 and q72 (full) at the reference's default shuffle conf (the
#: lz4 fallback codec), without the codec (the bytes it saves), q93 under
#: zstd; q5 (phase 8's class whose partial sums are raw float planes) as
#: the runs' codec witness: q93's and q72's planes all fit light-weight
#: encodings (bitpack, scaled, sparse), so the reference's chooser gives
#: them no codec plane either
CODEC_RUNS = (
    ("q93 (lz4)", "q93", None, 24),
    ("q93 (none)", "q93", {"exec.shuffle.encoding.fallback.codec": "none"}, 24),
    ("q93 (zstd)", "q93", {"exec.shuffle.encoding.fallback.codec": "zstd"}, 24),
    ("q72 (lz4)", "q72", {"auron.smj.elide.sorts": "full"}, 36),
    ("q72 (none)", "q72", {"auron.smj.elide.sorts": "full",
                           "exec.shuffle.encoding.fallback.codec": "none"}, 36),
    ("q5 (lz4)", "q5", None, 8),
    ("q5 (none)", "q5", {"exec.shuffle.encoding.fallback.codec": "none"}, 8),
)
#: phase 22: the memory budget of q93 on four slots: a map task's staged
#: batch (1 << 20 rows of 16 bytes) is larger than the manager's share of
#: it, so every map task spills from its second batch on, whatever the
#: threads' timing
SLOTS_SPILL_BUDGET = 8 << 20


def _shuffle_record(stats: dict) -> dict:
    """The shuffle counters and timers of a run's stats (any writer)."""
    c, t = stats.get("counters", {}), stats.get("timers", {})

    def total(d, suffix):
        return sum(v for k, v in d.items() if k.endswith(suffix))

    return {"shuffle_bytes_written": total(c, ".shuffle_bytes_written"),
            "shuffle_bytes_raw": total(c, ".shuffle_bytes_raw"),
            "shuffle_bytes_read": total(c, ".shuffle_bytes_read"),
            "enc_codec": total(c, ".shuffle_enc_codec"), "enc_arrow": total(c, ".shuffle_enc_arrow"),
            "compress_s": total(t, ".compress_time"), "decode_s": total(t, ".decode_time"),
            "push_s": total(t, ".push_time")}


def _timed(label: str, fn, want: dict, k1: int | None, stats: dict | None = None,
           check=None) -> dict:
    """One timed run of ``fn(stats)``: counts set to 0 just before and read
    just after, the answer held to ``want`` (or by ``check``), K1 as
    ``k1`` (when given) and no bitonic launch unless ``check`` allows."""
    import torch

    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = stats if stats is not None else {}
    t0 = time.perf_counter()
    got = fn(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    if check is not None:
        check(got, launches)
    else:
        _assert_answer(label, got, want)
        assert launches["bitonic_sort"] == launches["bitonic_merge"] == 0, (label, launches)
    if k1 is not None:
        assert launches["murmur3_pmod"] == k1, (label, launches)
    rec = {"wall_s": wall, "launches": launches, "peak_bytes": peak, **_shuffle_record(st)}
    print(f"{label}: wall {wall:.4f} s, shuffle bytes written {rec['shuffle_bytes_written']:,} "
          f"(raw {rec['shuffle_bytes_raw']:,}), read {rec['shuffle_bytes_read']:,}, "
          f"compress_time {rec['compress_s']:.4f} s, decode_time {rec['decode_s']:.4f} s, "
          f"push_time {rec['push_s']:.4f} s, shuffle_enc_codec {rec['enc_codec']}, "
          f"shuffle_enc_arrow {rec['enc_arrow']}, launches {launches}, peak "
          f"{peak / 2**30:.3f} GiB, {_from_bytes(st)}", flush=True)
    return rec


def run_udf_shuffle_phase(data, seed: int, kernels_checked: bool) -> dict:
    """Phase 22: the host callbacks and the shuffle tail at the phases'
    scale. (a) CODEC_RUNS, each class after a warm-up: walls, bytes against
    the same class without the codec, ``compress_time``, ``decode_time``,
    the codec and arrow column counts; fails if no codec plane was written
    or a codec was unavailable. (b) q93 with ``exec.shuffle.encoding=off``
    (v1 lz4 IPC blocks). (c) q93 through ``RssShuffleWriterExec`` to an
    ``RssNetServer`` on 127.0.0.1 with 2 replicas, read through
    ``RemoteBlockProvider``. (d) q93 and q72 (full) with map and reduce
    tasks on 4 slots (a CUDA stream each) against one after another, equal
    K1 counts; q93 on 4 slots under SLOTS_SPILL_BUDGET: spills certain.
    (e) ``run_udf_class``: its Hive UDF installed through the port's C
    library (``auron_register_udf_callback`` answers 0). Every answer equals
    its oracle. Without phase 3 (``kernels_checked`` False) K1 is held
    against its plain version here."""
    import torch

    from auron_tpu_torch.columnar import codecs
    from auron_tpu_torch.exec.shuffle import format as shuffle_format
    from auron_tpu_torch.models import tpcds

    if not kernels_checked:
        check_partition_kernel(seed)
    for name in ("lz4", "zstd"):
        assert codecs.available(name), f"the {name} codec is unavailable on this machine"
    shuffle_format._codec_warned.clear()
    t0 = time.perf_counter()
    fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
    inputs = {"q93": tpcds.ingest_q93(data, 4, device="cuda", fact=fact),
              "q72": tpcds.ingest_q72(data, 4, device="cuda", fact=fact),
              "q5": {"fact": fact}, "udf": tpcds.ingest_q3(data, 4, device="cuda", fact=fact)}
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    oracles = _oracles({"q93": lambda: _oracle("q93", data), "q72": lambda: _oracle("q72", data),
                        "q5": lambda: _oracle("q5", data),
                        "udf": lambda: tpcds.udf_class_oracle(data)})
    print(f"phase 22: inputs on the card in {t_ingest:.2f} s", flush=True)
    out: dict = {}

    def run(name, conf=None, **kw):
        return lambda st: getattr(tpcds, f"run_{name}_class")(
            device="cuda", conf=conf, ingested=inputs[name], stats=st, **kw)

    # (a) the codecs
    warmed: set = set()
    for label, name, conf, k1 in CODEC_RUNS:
        if name not in warmed:
            _assert_answer(f"{label} warm-up", run(name, conf)({}), oracles[name])
            warmed.add(name)
        out[label] = _timed(label, run(name, conf), oracles[name], k1)
    for name, lz4 in (("q93", "q93 (lz4)"), ("q72", "q72 (lz4)"), ("q5", "q5 (lz4)")):
        none = out[f"{name} (none)"]
        print(f"{name}: lz4 writes {out[lz4]['shuffle_bytes_written']:,} B against "
              f"{none['shuffle_bytes_written']:,} B without the codec "
              f"({out[lz4]['shuffle_bytes_written'] / max(none['shuffle_bytes_written'], 1):.4f}"
              f"), wall {out[lz4]['wall_s']:.4f} s against {none['wall_s']:.4f} s", flush=True)
    codec_planes = sum(r["enc_codec"] for label, r in out.items() if "none" not in label)
    assert codec_planes > 0, "no codec plane was written"
    # (b) v1 blocks
    out["q93 (encoding off)"] = _timed("q93 (encoding off)",
                                       run("q93", {"exec.shuffle.encoding": "off"}),
                                       oracles["q93"], 24)
    # (c) the remote shuffle service over TCP
    _assert_answer("q93 (rss) warm-up", run("q93", transport="rss")({}), oracles["q93"])
    out["q93 (rss)"] = rss = _timed("q93 (rss)", run("q93", transport="rss"), oracles["q93"], 24)
    assert rss["push_s"] > 0 and rss["shuffle_bytes_read"] > 0, rss
    # (d) concurrent task slots
    for name, conf, k1 in (("q93", None, 24), ("q72", {"auron.smj.elide.sorts": "full"}, 36)):
        seq = out[f"{name} (lz4)"]
        _assert_answer(f"{name} (4 slots) warm-up", run(name, conf, parallel=True)({}),
                       oracles[name])
        par = out[f"{name} (4 slots)"] = _timed(f"{name} (4 slots)",
                                                run(name, conf, parallel=True),
                                                oracles[name], k1)
        assert par["launches"] == seq["launches"], (name, par["launches"], seq["launches"])
        print(f"{name}: 4 slots {par['wall_s']:.4f} s against one after another "
              f"{seq['wall_s']:.4f} s ({seq['wall_s'] / par['wall_s']:.3f}x), K1 "
              f"{par['launches']['murmur3_pmod']} both ways", flush=True)
    st: dict = {}
    rec = out["q93 (4 slots, budget)"] = _timed(
        "q93 (4 slots, budget)",
        run("q93", {"memory.hbm.budget.bytes": SLOTS_SPILL_BUDGET}, parallel=True),
        oracles["q93"], 24, st)
    spilled = st["counters"].get("ShuffleWriterExec.spilled_shuffle_runs", 0)
    rec.update(num_spills=st["memory"]["num_spills"], spilled_shuffle_runs=spilled,
               disk_bytes=st["memory"]["disk_bytes"])
    assert spilled >= 4 and st["memory"]["num_spills"] >= 4, (st["memory"], spilled)
    print(f"q93 (4 slots, budget {SLOTS_SPILL_BUDGET:,} B): {st['memory']['num_spills']} spills, "
          f"{spilled} spilled shuffle runs, {st['memory']['disk_bytes']:,} B on disk; equal "
          f"to the oracle", flush=True)
    # (e) the host callbacks
    shapes: list = []
    with _recording_kernel_sorts(shapes):
        warm = tpcds.run_udf_class(device="cuda", ingested=inputs["udf"], install="library")
    assert tpcds.udf_mismatch(warm, oracles["udf"]) is None

    def udf_check(got, launches):
        bad = tpcds.udf_mismatch(got, oracles["udf"])
        assert bad is None, ("udf class", bad)
        _assert_planned_launches("udf class", shapes, launches)
        # the UDAF shuffles on i_category, a string: the generic hash, no K1
        assert launches["murmur3_pmod"] == 0, launches

    st = {}
    rec = out["udf class"] = _timed(
        "udf class", lambda s: tpcds.run_udf_class(device="cuda", ingested=inputs["udf"],
                                                   stats=s, install="library"),
        None, None, st, check=udf_check)
    reads = {path: sum(v for k, v in st[path].get("counters", {}).items()
                       if k.endswith(".blocking_reads")) for path in st["walls"]}
    rec.update(walls=st["walls"], udf=st["udf"], register_rc=st["register_rc"],
               blocking_reads=reads, sort_shapes=shapes, geo_shuffle=_shuffle_record(st["geo"]))
    assert st["register_rc"] == 0
    print(f"udf class: auron_register_udf_callback answered {st['register_rc']}; walls "
          + ", ".join(f"{k} {v:.4f} s" for k, v in st["walls"].items())
          + f"; host UDF callbacks {st['udf']['calls']} calls over {st['udf']['rows']:,} "
          f"slots in {st['udf']['seconds']:.4f} s; device reads (blocking) {reads}; the "
          f"UDAF's pickled states {rec['geo_shuffle']['shuffle_bytes_written']:,} B of shuffle; "
          f"kernel sorts (NP, P) {shapes}", flush=True)
    assert not shuffle_format._codec_warned, \
        f"unavailable-codec warnings: {sorted(shuffle_format._codec_warned)}"
    print(f"phase 22: {codec_planes} codec planes written, no codec unavailable", flush=True)
    del inputs, fact
    return out


#: phase 23: timed runs of each SQL corpus query after its warm-up
SQL_TIMED_RUNS = 1  # one: the whole script keeps inside its time limit


def _sql_line(name: str, rec: dict) -> str:
    runs = rec["runs"]
    return (f"sql {name}: compile {rec['compile_s']:.4f} s, engine "
            + " / ".join(f"{s:.4f}" for s in rec["engine_s"])
            + f" s, oracle {rec['oracle_s']:.4f} s, rows {rec['rows']}, shuffle bytes "
            f"{runs[-1]['shuffle_bytes']:,} (mode "
            f"{','.join(ex['mode'] for ex in runs[-1]['exchanges']) or 'none'}), peak "
            f"{max(r['peak_bytes'] or 0 for r in runs) / 2**30:.3f} GiB, launches "
            + " / ".join(str({k: v for k, v in r["launches"].items() if v}) for r in runs))


def run_sql_phase(data, seed: int, kernels_checked: bool) -> dict:
    """Phase 23: the SQL gate (``models/sqlgate.py``) at the phases' scale.
    The catalog's tables from the phases' data (timed), their pandas frames
    for the oracles; the 11 unsupported texts must raise SqlUnsupported
    with the reference's construct at a line >= 1. Then every corpus text:
    compiled, its plan text equal to ``tests/goldens/sql/<name>.txt``, one
    warm-up on the card (its kernel sorts recorded and held against the
    plain network on the card, bit for bit) while the pandas oracles run
    in threads beside the warm-ups; then, with every oracle done,
    SQL_TIMED_RUNS timed runs, the counts set to 0 just before and read
    just after. Every answer (warm-up and timed) equals its oracle; each
    timed run launches K2 once per source shard of each exchange and the
    bitonic kernels as ``sort_plan`` lists for the sorts the warm-up
    recorded. Without phase 3 (``kernels_checked`` False) K1 and K2 are
    held against their plain versions here."""
    from concurrent.futures import ThreadPoolExecutor

    from auron_tpu_torch.models import sqlgate
    from auron_tpu_torch.sql.catalog import build_tables, frames_of

    if not kernels_checked:
        check_partition_kernel(seed)
        check_histogram_kernel(seed)
    t0 = time.perf_counter()
    tables = build_tables(data, seed=seed)
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = frames_of(tables)
    t_frames = time.perf_counter() - t0
    catalog = sqlgate.gate_catalog()
    unsupported = sqlgate.run_unsupported(catalog)
    bad = [r for r in unsupported if not r["ok"]]
    assert len(unsupported) == 11 and not bad, bad
    print(f"phase 23: catalog tables in {t_tables:.2f} s ({len(tables['store_sales']):,} "
          f"fact rows), pandas frames in {t_frames:.2f} s; the 11 unsupported texts raise "
          + ", ".join(f"{r['query']} {r['construct']!r} @{r['line']}:{r['col']}"
                      for r in unsupported), flush=True)
    names = [c.name for c in sqlgate.CASES]
    cache: dict = {}
    out: dict = {"tables_s": t_tables, "frames_s": t_frames, "unsupported": unsupported,
                 "queries": {}}
    warm: dict = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as pool:
        pending = {n: pool.submit(sqlgate.oracle_answer, sqlgate.case_by_name(n), frames)
                   for n in names}
        for name in names:
            sorts: list = []
            shapes: list = []
            with _recording_sorts(sorts), _recording_kernel_sorts(shapes):
                rec, = sqlgate.run_gate(names=[name], device="cuda", tables=tables,
                                        frames=frames, cache=cache, runs=0, warmup=True,
                                        oracles={name: pending[name].result})
            assert rec["ok"], (name, rec["error"])
            warm[name] = {"rec": rec, "shapes": shapes,
                          "sort_checks": check_sorts(f"sql {name}", sorts)}
            del sorts
        oracles = {n: f.result() for n, f in pending.items()}
    t_warm = time.perf_counter() - t0
    # a replicated view is one upload shared by every partition
    slots = {id(b): b.capacity for v in cache.values() for p in v for b in p}
    print(f"phase 23: warm-ups and oracles in {t_warm:.2f} s (oracles "
          f"{sum(s for _, s in oracles.values()):.2f} s summed over {ORACLE_THREADS} threads); "
          f"the tables on "
          f"the card: {sum(slots.values()):,} batch slots under {sorted(r for r, _ in cache)}",
          flush=True)
    for name in names:
        _reset_launches()
        rec, = sqlgate.run_gate(names=[name], device="cuda", tables=tables, frames=frames,
                                cache=cache, runs=SQL_TIMED_RUNS,
                                oracles={name: lambda n=name: oracles[n]})
        launches = _launches()
        assert rec["ok"], (name, rec["error"])
        summed = {k: sum(r["launches"][k] for r in rec["runs"]) for k in launches}
        assert summed == launches, (name, summed, launches)
        for run in rec["runs"]:
            shards = sum(len(ex["routing"]) for ex in run["exchanges"])
            assert run["launches"]["partition_histogram"] == shards, (name, run["launches"])
            _assert_planned_launches(f"sql {name}", warm[name]["shapes"], run["launches"],
                                     sorts=bool(warm[name]["shapes"]))
        print(_sql_line(name, rec) + f"; warm-up {warm[name]['rec']['warm']['engine_s']:.4f} s, "
              f"kernel sorts (NP, P) {warm[name]['shapes']}", flush=True)
        out["queries"][name] = {**rec, "warm": warm[name]["rec"]["warm"],
                                "sort_shapes": warm[name]["shapes"],
                                "sort_checks": warm[name]["sort_checks"]}
    k2 = [n for n, r in out["queries"].items() if r["runs"][-1]["launches"]["partition_histogram"]]
    assert len(k2) == 21, f"K2 launched on {len(k2)} of the SQL plans, not 21: {k2}"
    del cache
    return out, {"tables": tables, "frames": frames, "oracles": oracles}


#: phase 24: the gate's concurrent clients (the reference's
#: ``serve.gate.clients`` default: 8 clients queue on 4 admission slots)
SERVE_CLIENTS = 8
#: phase 24: the concurrent/serial queries/s the gate is held to here: no
#: slower than one client. The reference's floor on an accelerator is 2.0
#: (``servegate.run_gate``'s default on cuda), which the port does not
#: reach: a served query is host dispatch under one interpreter lock, and
#: with one query dispatching at a time (``runtime/dispatch.py``) 8 clients
#: get about the serial rate (PERF.md §6). The ratio is printed against 2.0
SERVE_MIN_SPEEDUP = 1.0
#: phase 24: the serial corpus passes of the recorder A/B, alternating;
#: the whole script runs one a mode, so that it ends inside its time limit
SERVE_AB_MODES = ("off", "recorder", "off", "recorder")
SERVE_AB_MODES_IN_SCRIPT = ()  # the whole script keeps inside its time limit
#: phase 24: the queries POST /sql sends over one keep-alive connection
SERVE_HTTP_QUERIES = ("q3", "q46", "q65")


def _sql_reference(data, seed: int) -> tuple[dict, dict]:
    """``--serve-only``: phase 23's inputs and per-query launches without
    phase 23: the tables, frames and oracles (threads beside the
    warm-ups), then one timed run of each query after its warm-up."""
    from concurrent.futures import ThreadPoolExecutor

    from auron_tpu_torch.models import sqlgate
    from auron_tpu_torch.sql.catalog import build_tables, frames_of

    check_partition_kernel(seed)
    check_histogram_kernel(seed)
    tables = build_tables(data, seed=seed)
    frames = frames_of(tables)
    names = [c.name for c in sqlgate.CASES]
    cache: dict = {}
    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as pool:
        pending = {n: pool.submit(sqlgate.oracle_answer, sqlgate.case_by_name(n), frames)
                   for n in names}
        for name in names:
            rec, = sqlgate.run_gate(names=[name], device="cuda", tables=tables, frames=frames,
                                    cache=cache, runs=0, warmup=True,
                                    oracles={name: pending[name].result})
            assert rec["ok"], (name, rec["error"])
        oracles = {n: f.result() for n, f in pending.items()}
    queries = {}
    for name in names:
        rec, = sqlgate.run_gate(names=[name], device="cuda", tables=tables, frames=frames,
                                cache=cache, runs=1,
                                oracles={name: lambda n=name: oracles[n]})
        assert rec["ok"], (name, rec["error"])
        queries[name] = rec
    del cache
    return {"queries": queries}, {"tables": tables, "frames": frames, "oracles": oracles}


def _http(conn, method: str, path: str, body=None) -> tuple[int, bytes]:
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"} if body is not None else {})
    r = conn.getresponse()
    return r.status, r.read()


def _serve_http_leg(port: int, answers: dict, text53: str) -> dict:
    """POST /sql over one keep-alive connection: q3, q46 and q65 (rows equal
    to the served answers, which equal their oracles), q53 and a denied conf
    key (400 each); then, while a client serves queries over another
    connection, every observability endpoint answers 200 with a parseable
    body."""
    import http.client
    import threading

    from auron_tpu_torch.models import sqlgate
    from auron_tpu_torch.serve.server import _json_rows

    out: dict = {"sql": {}}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        for name in SERVE_HTTP_QUERIES:
            t0 = time.perf_counter()
            code, body = _http(conn, "POST", "/sql", {"sql": sqlgate.case_by_name(name).sql,
                                                      "tenant": "http"})
            wall = time.perf_counter() - t0
            assert code == 200, (name, code, body[:300])
            resp = json.loads(body)
            assert resp["cache_hit"], name
            assert resp["columns"] == list(answers[name].columns), name
            assert resp["rows"] == _json_rows(answers[name]), f"POST /sql {name}: rows differ"
            out["sql"][name] = {"wall_s": wall, "rows": len(resp["rows"]),
                                "trace_id": resp["trace_id"]}
        sock = conn.sock
        code, body = _http(conn, "POST", "/sql", {"sql": text53})
        assert code == 400 and "error" in json.loads(body), (code, body[:300])
        code, body = _http(conn, "POST", "/sql", {"sql": sqlgate.case_by_name("q3").sql,
                                                  "conf": {"obs.mode": "off"}})
        assert code == 400 and "not session-settable" in json.loads(body)["error"], body
        assert conn.sock is sock, "the keep-alive connection was not reused"
    finally:
        conn.close()

    stop = threading.Event()
    served: list = []
    errors: list = []

    def client():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            i = 0
            while not stop.is_set():
                name = SERVE_HTTP_QUERIES[i % len(SERVE_HTTP_QUERIES)]
                code, body = _http(c, "POST", "/sql", {"sql": sqlgate.case_by_name(name).sql,
                                                       "tenant": "background"})
                if code != 200:
                    errors.append((name, code, body[:300]))
                served.append(name)
                i += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    gets = {}
    try:
        while not served and t.is_alive():  # a query is in flight from here on
            time.sleep(0.01)
        for path in ("/healthz", "/metrics", "/metrics.prom", "/trace?last=5", "/queries",
                     "/serve"):
            t0 = time.perf_counter()
            code, body = _http(conn, "GET", path)
            assert code == 200, (path, code, body[:300])
            if path == "/healthz":
                assert body == b"ok\n"
            elif path == "/metrics.prom":
                text = body.decode()
                assert "auron_engine_compiles_total" in text and "# TYPE" in text, text[:300]
            else:
                payload = json.loads(body)
                if path.startswith("/trace"):
                    assert payload["traceEvents"], "no recent trace events"
            gets[path] = {"wall_s": time.perf_counter() - t0, "bytes": len(body)}
    finally:
        conn.close()
        stop.set()
        t.join(600)
    assert not errors, errors
    out["gets"] = gets
    out["background_queries"] = len(served)
    return out


def _serial_pass_s(server, names: list) -> float:
    from auron_tpu_torch.models import sqlgate

    t0 = time.perf_counter()
    for name in names:
        server.submit(sqlgate.case_by_name(name).sql, tenant="ab")
    return time.perf_counter() - t0


def _print_serve_legs(rec: dict) -> None:
    """Where each timed leg's time went (``servegate._leg_record``): CPU
    over wall, host syncs by site, settles, lock waits, spills."""
    for leg, r in rec["legs"].items():
        sites = ", ".join(f"{k} {n}/{sec:.3f} s" for k, (n, sec) in
                          list(r["sync_sites"].items())[:4])
        print(f"serve {leg} leg: wall {r['wall_s']:.3f} s, CPU {r['cpu_s']:.3f} s "
              f"({r['cpu_per_wall']:.3f} of wall), host syncs {r['host_syncs']} "
              f"({r['host_sync_s']:.3f} s; {sites or 'no site above 1 ms'}), async reads "
              f"{r['async_reads']}, settles {r['settles']} ({r['settle_s']:.3f} s), "
              f"lock waits {json.dumps(r['lock_waits'])}, spills {r['spills']}, memory waits "
              f"{r['mem_waits']}, allocator retries {r.get('num_alloc_retries')}, device "
              f"segments {r.get('num_device_alloc')}", flush=True)


def run_serve_phase(data, sf: float, seed: int, clients: int, sql: dict | None = None,
                    shared: dict | None = None, ab_modes=SERVE_AB_MODES,
                    profile: bool = False) -> dict:
    """Phase 24: the SQL corpus served (``serve/``, ``models/servegate.py``)
    over phase 23's tables (``sql``/``shared``; else built here, with one
    warm-up and one timed run of each query for the launches). A
    ``SqlServer`` on the card at P = 2 with the admission defaults and the
    HTTP service on loopback; the gate's three legs with ``clients``
    clients and no speedup floor; the HTTP leg; the recorder A/B."""
    import torch

    from auron_tpu_torch import obs
    from auron_tpu_torch.models import servegate, sqlgate
    from auron_tpu_torch.models.compare import compare_frames
    from auron_tpu_torch.obs import core as obs_core
    from auron_tpu_torch.serve import SqlServer
    from auron_tpu_torch.utils import httpsvc
    from auron_tpu_torch.utils.profiling import EngineCounters

    if sql is None:
        sql, shared = _sql_reference(data, seed)
    names = [c.name for c in sqlgate.CASES]
    counters = EngineCounters.install()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = SqlServer(sqlgate.gate_catalog(), shared["tables"], n_parts=2, device="cuda")
    port = httpsvc.start(0)
    httpsvc.install_sql_server(server)
    print(f"phase 24: SqlServer on {server.device} at P = {server.n_parts}, admission "
          f"{server.admission.max_concurrent} at once, HTTP service on 127.0.0.1:{port} "
          f"(obs mode {obs.mode_name()})", flush=True)
    out: dict = {"clients": clients}
    try:
        answers: dict = {}
        rec = servegate.run_gate(sf=sf, clients=clients, names=names, server=server,
                                 min_speedup=SERVE_MIN_SPEEDUP, answers=answers)
        out["gate"] = rec
        _print_serve_legs(rec)
        assert rec["ok"], rec["failures"]
        assert rec["queries"] == 24 and rec["trace_ids"] == 24 * (1 + clients), rec
        for name in names:
            want = shared["oracles"][name][0]
            err = compare_frames(answers[name], want, 1e-6, sorted_rows=True)
            assert err is None, (name, err)
            got, ref = rec["launches"]["serial"][name], sql["queries"][name]["runs"][-1]["launches"]
            assert got == ref, f"serve {name}: serial-leg launches {got} != phase 23's {ref}"
        serial_total = {k: sum(q[k] for q in rec["launches"]["serial"].values())
                        for k in rec["launches"]["concurrent"]}
        assert rec["launches"]["concurrent"] == {k: clients * v
                                                 for k, v in serial_total.items()}, \
            (rec["launches"]["concurrent"], serial_total)
        reached = rec["speedup"] >= 2.0
        for leg in ("serial", "concurrent"):
            print(f"serve {leg}: {rec[leg + '_s']:.3f} s, {rec[leg + '_qps']:.3f} queries/s, "
                  f"p50 {rec[leg]['p50_ms']} ms, p99 {rec[leg]['p99_ms']} ms", flush=True)
        print(f"serve warm: {rec['warm_s']:.3f} s for 24 queries; concurrent/serial "
              f"{rec['speedup']:.3f}x (asserted >= {SERVE_MIN_SPEEDUP}); the reference's "
              f"2.0x: {'met' if reached else 'not met'}", flush=True)
        print(f"serve launches: serial pass {serial_total}, {clients} clients "
              f"{rec['launches']['concurrent']}; compiles in legs 2-3: "
              f"{rec['replay_compiles']} / {rec['concurrent_compiles']}", flush=True)
        out["http"] = _serve_http_leg(port, answers, sqlgate.UNSUPPORTED["q53"][0])
        print(f"serve http: POST /sql "
              + ", ".join(f"{n} {v['wall_s']:.4f} s ({v['rows']} rows)"
                          for n, v in out["http"]["sql"].items())
              + "; q53 and obs.mode 400; GETs "
              + ", ".join(f"{p} {v['wall_s']:.4f} s ({v['bytes']:,} B)"
                          for p, v in out["http"]["gets"].items())
              + f" while {out['http']['background_queries']} queries were served", flush=True)
        prev = obs.mode_name()
        ab = {"off": [], "recorder": []}
        try:
            for mode in ab_modes:
                obs.set_mode(mode)
                ab[mode].append(_serial_pass_s(server, names))
        finally:
            obs.set_mode(prev)
        out["recorder_ab"] = ab
        if profile:
            out["profile"] = [servegate.profiled_pass(server, names, n) for n in (1, clients)]
            for p in out["profile"]:
                print(f"serve profile ({p['clients']} client{'s' * (p['clients'] > 1)}, the 24 "
                      f"texts once): wall {p['wall_ms']:.3f} ms, device busy "
                      f"{p['device_busy_ms']:.3f} ms, idle share {p['device_idle_share']:.4f}",
                      flush=True)
        if ab_modes:
            print(f"serve recorder A/B (serial corpus passes, alternating): off "
                  + " / ".join(f"{x:.4f}" for x in ab["off"]) + " s, recorder "
                  + " / ".join(f"{x:.4f}" for x in ab["recorder"]) + " s", flush=True)
    finally:
        httpsvc.stop()
    out["stats"] = server.stats()
    out["counters"] = counters.snapshot()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["trace_events"] = sum(len(evs) for _, evs in obs_core.snapshot_events())
    out["launches"] = rec["launches"]
    out["wall_s"] = time.perf_counter() - t0
    print(f"serve stats: {json.dumps(out['stats'])}", flush=True)
    print(f"serve engine counters: {json.dumps(out['counters'])}", flush=True)
    print(f"serve peak device memory {out['peak_bytes'] / 2**30:.3f} GiB, "
          f"{out['trace_events']:,} trace events in the recorder's rings", flush=True)
    return out


#: phase 25 (a): the stream gate's events, reps and poll (the reference's
#: defaults) in the whole script; ``--stream-only`` runs 1,000,000 events
STREAM_GATE_EVENTS = 60_000
STREAM_GATE_EVENTS_ONLY = 1_000_000
STREAM_GATE_REPS = 3
STREAM_POLL = 512
#: phase 25 (b): the served streams' second view, over a second topic
STREAM_HOP_VIEW = """
CREATE STREAMING VIEW clicks_hop
  WATERMARK FOR ts AS ts - INTERVAL '1' SECOND
AS SELECT k, window_start, window_end, SUM(v) AS total, COUNT(*) AS n,
          MAX(v) AS hi
   FROM clicks
   GROUP BY k, HOP(ts, INTERVAL '1' SECOND, INTERVAL '2' SECOND)
"""
#: phase 25 (c): the keyed exchange's events (``--stream-only``: 4,000,000),
#: users and reduce partitions
EXCHANGE_EVENTS = 1_000_000
EXCHANGE_EVENTS_ONLY = 4_000_000
EXCHANGE_USERS = 200_000
EXCHANGE_REDUCE = 4


def _stream_diag():
    """``tools/stream_diag.py`` of this checkout, as a module (its
    breakdown of a step wraps the pipeline's calls from outside)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "stream_diag", os.path.join(REPO_DIR, "tools", "stream_diag.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream_gate_leg(events: int) -> dict:
    """Phase 25 (a): the JSON deserializer held to its record loop on the
    ingest edge cases and the gate's corpus; the stream gate on the card at
    the reference's floor (``run_gate``'s default, 1.05x), its emissions
    against the numpy oracle of the view; then a step of each leg taken
    apart (``tools/stream_diag.py``), printed."""
    from auron_tpu_torch.models import streamgate

    t0 = time.perf_counter()
    bad, ingest = streamgate.ingest_mismatches()
    print(f"stream ingest: the columnar JSON read equals the record loop on "
          f"{len(streamgate.ingest_edge_polls())} edge polls under skip, null and fail "
          f"(columnar {ingest['edge_columnar_polls']}, loop {ingest['edge_loop_polls']}) and "
          f"on the gate's corpus (columnar {ingest['corpus_columnar_polls']}, loop "
          f"{ingest['corpus_loop_polls']}); differing: {bad or 'none'} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    assert not bad, bad
    assert ingest["corpus_loop_polls"] == 0, ingest
    ems: list = []
    _reset_launches()
    t0 = time.perf_counter()
    rec = streamgate.run_gate(events=events, reps=STREAM_GATE_REPS, poll=STREAM_POLL,
                              device="cuda", emissions=ems)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _launches()
    rec["ingest"] = ingest
    print(f"stream gate: fused {rec['fused_events_s']:,.1f} events/s, eager "
          f"{rec['eager_events_s']:,.1f} events/s (best of {STREAM_GATE_REPS} reps each, "
          f"a rep stepping both legs in turns of {streamgate.TURN_STEPS} steps, after a "
          f"warm-up run of each), "
          f"fused/eager {rec['speedup']:.3f}x against the reference's floor "
          f"{rec['min_fused_speedup']:.2f}x: {'met' if rec['ok'] else 'FAILED'}; graph "
          f"captures and builds {rec['warm_compiles']} in the warm run, "
          f"{rec['replay_compiles']} in the timed reps; {rec['host_reads_per_step']} host "
          f"reads a step; polls read columnar {rec['columnar_polls']}, by the record loop "
          f"{rec['loop_polls']} (a timed fused run); peak device memory "
          f"{rec['peak_bytes'] / 2**20:.1f} MiB; {rec['wall_s']:.2f} s, launches "
          f"{rec['launches']}", flush=True)
    assert rec["ok"], rec["failures"]
    assert rec["replay_compiles"] == 0, rec
    assert rec["min_fused_speedup"] == 1.05, rec
    t0 = time.perf_counter()
    err = streamgate.oracle_mismatch(ems, streamgate.view_oracle(streamgate._corpus(events),
                                                                 STREAM_POLL))
    rec["oracle_s"] = time.perf_counter() - t0
    assert err is None, err
    print(f"stream gate: {events:,} events, poll {STREAM_POLL}, {rec['steps']} steps a run, "
          f"{rec['emissions']} emissions (each equal to the numpy oracle: keys, bounds and "
          f"counts exact, floats at rel 1e-9), {rec['checkpoints']} checkpoints in the "
          f"resumed run; fused, eager and crash-resumed logs bit-identical", flush=True)
    # after the gate, so that its result does not depend on the wrapped
    # runs: a step of each leg taken apart, printed
    t0 = time.perf_counter()
    rec["breakdown"] = _stream_diag().breakdown(events, STREAM_GATE_REPS, STREAM_POLL, "cuda")
    for leg, r in rec["breakdown"].items():
        parts = ", ".join(f"{k} {v:.3f}" for k, v in r["ms_per_step"].items() if k != "step")
        print(f"stream gate step, {leg} (tools/stream_diag.py, the fastest of "
              f"{STREAM_GATE_REPS} wrapped runs): {r['ms_per_step']['step']:.3f} ms a step "
              f"({parts}; the chain between CUDA events {r['calc_device_ms_per_step']} ms), "
              f"{r['events_s']:,.1f} events/s", flush=True)
    rec["breakdown_s"] = time.perf_counter() - t0
    return rec


def _stream_serve_leg(events: int) -> dict:
    """Phase 25 (b): two views served on the card through POST /stream."""
    import http.client

    from auron_tpu_torch import obs
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
    from auron_tpu_torch.models import streamgate
    from auron_tpu_torch.serve.streams import StreamServer
    from auron_tpu_torch.stream import CollectSink, StreamPipeline, lower_streaming_view
    from auron_tpu_torch.utils import httpsvc
    from auron_tpu_torch.utils.config import (
        STREAM_CHECKPOINT_INTERVAL, STREAM_POLL_MAX_RECORDS, STREAM_SERVE_MAX_STREAMS,
        Configuration,
    )

    topics = {"events": streamgate._corpus(events), "clicks": streamgate._corpus(events, 8)}
    views = {"streamgate_1s": (streamgate.VIEW, "events"),
             "clicks_hop": (STREAM_HOP_VIEW, "clicks")}
    conf = Configuration({STREAM_POLL_MAX_RECORDS.key: STREAM_POLL,
                          STREAM_CHECKPOINT_INTERVAL.key: 8,
                          STREAM_SERVE_MAX_STREAMS.key: len(views)})
    server = StreamServer(conf=conf, device="cuda")
    for name, parts in topics.items():
        server.register_topic(name, streamgate.SCHEMA, lambda mode, off, parts=parts:
                              MockKafkaSource(parts, startup_mode=mode, start_offsets=off))
    prev_mode = obs.mode_name()
    obs.set_mode("recorder")
    port = httpsvc.start(0)
    httpsvc.install_stream_server(server)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out: dict = {"events": events}
    t0 = time.perf_counter()
    try:
        sinks = {}
        for name, (sql, _) in views.items():
            code, body = _http(conn, "POST", "/stream", {"action": "register", "sql": sql})
            assert code == 200 and json.loads(body)["status"] == "running", (code, body)
            sinks[name] = server._get(name)["sink"]
        live = {}
        deadline = time.monotonic() + 120
        for name in views:
            while True:  # inspect until the stream has stepped
                code, body = _http(conn, "POST", "/stream", {"action": "inspect",
                                                             "stream": name})
                assert code == 200 and json.loads(body)["error"] is None, (code, body)
                live[name] = json.loads(body)["steps"]
                if live[name] or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            assert live[name] > 0, (name, body)
        code, body = _http(conn, "POST", "/stream", {
            "action": "register", "sql": streamgate.VIEW.replace("streamgate_1s", "third")})
        assert code == 429 and "max.streams" in json.loads(body)["error"], (code, body)
        deadline = time.monotonic() + 300
        while not all(server.inspect(n)["exhausted"] for n in views):
            assert time.monotonic() < deadline, "served streams did not drain their topics"
            time.sleep(0.01)
        code, body = _http(conn, "POST", "/stream", {"action": "list"})
        assert code == 200 and sorted(s["stream"] for s in json.loads(body)["streams"]) == \
            sorted(views), body
        finals = {}
        for name in views:
            code, body = _http(conn, "POST", "/stream",
                               {"action": "cancel", "stream": name, "drain": True})
            assert code == 200, (code, body)
            finals[name] = json.loads(body)["final"]
        out["served_s"] = time.perf_counter() - t0
        code, body = _http(conn, "GET", "/queries")
        traces = {q["name"]: q["trace_id"] for q in json.loads(body)}
        for name in views:
            assert f"stream.{name}" in traces, (name, sorted(traces))
        assert len({traces[f"stream.{n}"] for n in views}) == len(views), traces
    finally:
        conn.close()
        httpsvc.stop()
        server.shutdown()
        obs.set_mode(prev_mode)
    t1 = time.perf_counter()
    for name, (sql, topic) in views.items():
        sink = CollectSink()
        p = StreamPipeline(lower_streaming_view(sql, streamgate.SCHEMA),
                           MockKafkaSource(topics[topic]), JsonRowDeserializer(streamgate.SCHEMA),
                           sink, conf=conf.copy(), device="cuda")
        p.run(drain=True)
        p.close()
        got = [e.to_json() for e in sinks[name].emissions]
        assert got == [e.to_json() for e in sink.emissions], f"served {name} != alone"
        out[name] = {"emissions": len(got), "steps": finals[name]["steps"],
                     "inspected_steps": live[name], "checkpoints": finals[name]["checkpoints"]}
    out["alone_s"] = time.perf_counter() - t1
    print(f"stream serve: POST /stream registered {sorted(views)} on 127.0.0.1:{port}, "
          f"inspected them running (steps {live}), the third registration 429 at "
          f"stream.serve.max.streams={len(views)}, cancelled with drain after "
          f"{out['served_s']:.2f} s; "
          + ", ".join(f"{n} {out[n]['emissions']} emissions in {out[n]['steps']} steps"
                      for n in views)
          + f", each bit-identical to its view run alone ({out['alone_s']:.2f} s for both) and "
          f"under its own stream.<view> trace in /queries", flush=True)
    return out


def _stream_exchange_leg(events: int) -> dict:
    """Phase 25 (c): planned kafka_scan map tasks, a keyed file exchange
    and sorted reduce tasks, from TaskDefinition bytes on the card."""
    import torch

    from auron_tpu_torch.models import kafka_exchange as KX

    t0 = time.perf_counter()
    parts = KX.corpus(events, EXCHANGE_USERS)
    out: dict = {"events": events, "users": EXCHANGE_USERS, "corpus_s": time.perf_counter() - t0}
    batches = KX.micro_batches(parts)
    # prediction: the partial aggregate folds every micro-batch into its
    # dense table and hands the writer one state batch at the end of its
    # input, so K1 launches once a map task, not once a micro-batch
    k1_predicted = len(parts)
    record: list = []
    shapes: list = []
    with _recording_sorts(record), _recording_kernel_sorts(shapes):
        KX.run(parts, EXCHANGE_REDUCE, device="cuda")  # warm-up: builds, captures
    out["sort_checks"] = check_sorts("stream exchange", record)
    del record
    t0 = time.perf_counter()
    want = KX.oracle(parts)
    out["oracle_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    st: dict = {}
    outs = KX.run(parts, EXCHANGE_REDUCE, device="cuda", stats=st)
    launches = _launches()
    out.update(stats=st, launches=launches, micro_batches=batches, k1_predicted=k1_predicted,
               peak_bytes=torch.cuda.max_memory_allocated())
    err = KX.mismatch(outs, want)
    assert err is None, err
    ends = {p: len(part) for p, part in enumerate(parts)}
    assert st["offsets"] == ends, (st["offsets"], ends)
    assert st["stream_batches"] == batches, (st["stream_batches"], batches)
    assert launches["murmur3_pmod"] == k1_predicted, (launches, k1_predicted)
    _assert_planned_launches("stream exchange", shapes, launches)
    print(f"stream exchange: {events:,} events of {EXCHANGE_USERS:,} users in "
          f"{len(parts)} topic partitions ({out['corpus_s']:.2f} s to make), "
          f"{len(parts)} map x {EXCHANGE_REDUCE} reduce tasks from bytes: wall "
          f"{st['wall_s']:.3f} s (map {st['map_s']:.3f}, reduce {st['reduce_s']:.3f}), "
          f"{st['stream_batches']} micro-batches, deserialize {st['deserialize_s']:.3f} s, "
          f"shuffle {st['shuffle_bytes']:,} B, rows per partition {st['rows']}; equal to the "
          f"pandas group-by ({out['oracle_s']:.2f} s; counts exact, totals at rel 1e-9, "
          f"order exact); kafka_offset_p* {st['offsets']} = the topic's ends; launches "
          f"{launches} (K1 predicted {k1_predicted}: one a map task; K3/K4 as sort_plan "
          f"lists for {shapes}); peak {out['peak_bytes'] / 2**20:.1f} MiB", flush=True)
    return out


def run_stream_phase(gate_events: int | None, exchange_events: int) -> dict:
    """Phase 25: streaming (``exec/streaming.py``, ``exec/kafka_wire.py``,
    ``stream/``, ``StreamTaskRuntime``, ``serve/streams.py``, ``POST
    /stream``, ``models/streamgate.py``) on the card: (a) the stream gate,
    (b) two views served through POST /stream, (c) planned kafka_scan
    tasks with a keyed exchange. ``gate_events`` None leaves (a) to
    ``run_stream_gate`` (the whole script times it once the first process
    has ended its phases)."""
    out = {} if gate_events is None else {"gate": _stream_gate_leg(gate_events)}
    out["serve"] = _stream_serve_leg(STREAM_GATE_EVENTS)
    out["exchange"] = _stream_exchange_leg(exchange_events)
    out["launches"] = {"stream exchange": out["exchange"]["launches"]}
    if "gate" in out:
        out["launches"]["stream gate"] = out["gate"]["launches"]
    return out


def run_stream_gate(stream: dict, gate_events: int) -> None:
    """Phase 25 (a) into ``stream`` (``run_stream_phase``'s record)."""
    stream["gate"] = _stream_gate_leg(gate_events)
    stream["launches"]["stream gate"] = stream["gate"]["launches"]


# ---------------------------------------------------------------------------
# phase 26: multi-process SPMD (parallel/multihost.py, the SPMD driver, the
# cross-process exchange, the step functions)
# ---------------------------------------------------------------------------

#: logical partitions of phase 26 and the worker processes owning them: two
#: ranks share the one card, so their data plane is gloo (NCCL refuses two
#: ranks on one device)
SPMD_PARTS = 4
SPMD_RANKS = 2
#: leg (c): rows a partition of sharded_agg_exchange_step, keys drawn from
#: [0, 2^20), slots of 2^19 groups a (source, destination) pair
SPMD_AGG_ROWS = 1 << 22
SPMD_AGG_KEYS = 1 << 20
SPMD_AGG_SLOT_CAP = 1 << 19
#: leg (d): rows a partition through the world-1 NCCL group; half the ids
#: bunched on partition 0 overflow its 2^20 slots
SPMD_NCCL_ROWS = 1 << 22
SPMD_NCCL_SLOT_CAP = 1 << 20
SPMD_WORKER_TIMEOUT_S = 300
SPMD_CATS = ("Books", "Home", "Electronics", "Music", "Sports", "Garden", "Toys")
SPMD_Q93_CONF = {"exchange.coalesce.enable": "false"}
#: leg (a)'s transports in order: the file runs (a warm-up and a timed run)
#: go first, so the mesh transport's one run finds the map stage warm
SPMD_Q93_MODES = ("file", "mesh")


def _spmd_dict_plan(n_parts: int):
    """Leg (b): the reference's SPMD STRING group-by (``tests/test_multihost.py``
    ``_SPMD_DICT_WORKER``): partial hash_agg on the dict-encoded key ->
    mesh_exchange on it -> final hash_agg."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.plan import builders as B

    schema = T.Schema((T.Field("cat", T.STRING, False), T.Field("v", T.INT64, False)))
    scan = B.memory_scan(schema, "fact")
    partial = B.hash_agg(scan, [(col(0), "cat")], [("sum", col(1), "s"),
                                                   ("count_star", None, "c")], "partial")
    ex = B.mesh_exchange(partial, B.hash_partitioning([col(0)], n_parts), "ex0")
    return schema, B.hash_agg(ex, [(col(0), "cat")], [("sum", col(1), "s"),
                                                      ("count", col(2), "c")], "final")


def _spmd_dict_parts(n_rows: int, n_parts: int, seed: int, device, only=None):
    """Leg (b)'s input: ``n_rows`` rows in ``n_parts`` partitions; partition p
    codes into its own dictionary, 4 of the 7 categories from p on (mod 7)
    in a rotated order, so every shard (and process) sees a different subset
    of the vocabulary. Returns (per-partition batch lists, empty outside
    ``only``; the numpy oracle {category: (sum, count)})."""
    import numpy as np

    from auron_tpu_torch.columnar.batch import Batch, object_array

    schema, _ = _spmd_dict_plan(n_parts)
    rng = np.random.default_rng(seed)
    per = n_rows // n_parts
    parts, sums, counts = [], np.zeros(len(SPMD_CATS)), np.zeros(len(SPMD_CATS), np.int64)
    for p in range(n_parts):
        codes = rng.integers(0, 4, per).astype(np.int32)
        v = rng.integers(-300, 300, per).astype(np.int64)
        ids = np.array([(p + j) % len(SPMD_CATS) for j in (3, 1, 0, 2)])
        sums += np.bincount(ids[codes], weights=v, minlength=len(SPMD_CATS))
        counts += np.bincount(ids[codes], minlength=len(SPMD_CATS))
        parts.append([] if only is not None and p not in only else [Batch.from_numpy(
            [codes, v], schema, dicts=[object_array([SPMD_CATS[i] for i in ids]), None],
            device=device)])
    oracle = {c: (int(s), int(n)) for c, s, n in zip(SPMD_CATS, sums, counts) if n}
    return parts, oracle


def _spmd_agg_inputs(seed: int):
    """Leg (c)'s stacked [P, 2^22] keys, values and liveness (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (SPMD_PARTS, SPMD_AGG_ROWS)
    return (rng.integers(0, SPMD_AGG_KEYS, shape).astype(np.int64), rng.normal(size=shape),
            rng.random(shape) < 0.9)


def _spmd_nccl_inputs(seed: int):
    """Leg (d)'s stacked [P, 2^22] columns (int64, float64, int32, bool),
    liveness and ids (half bunched on partition 0), as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (SPMD_PARTS, SPMD_NCCL_ROWS)
    pid = np.where(rng.random(shape) < 0.5, 0, rng.integers(0, SPMD_PARTS, shape))
    return ([rng.integers(-2**62, 2**62, shape).astype(np.int64), rng.normal(size=shape),
             rng.integers(-1000, 1000, shape).astype(np.int32), rng.random(shape) < 0.5],
            rng.random(shape) < 0.8, pid.astype(np.int32))


def _digests(tensors) -> list:
    """sha256 of each tensor's bytes (moved to the host)."""
    import hashlib

    return [hashlib.sha256(t.detach().contiguous().cpu().view(-1).numpy().view("u1")
                           .tobytes()).hexdigest() for t in tensors]


def _spmd_mesh_record(wall: float, st: dict, launches: dict) -> dict:
    return {"wall_s": wall, "map_s": st["map_s"], "exchange_s": st["exchange_s"],
            "reduce_s": st["reduce_s"],
            "routing": st["routing"], "slot_cap": st["slot_cap"], "mode": st["mode"],
            "peak_bytes": st["peak_bytes"], "launches": launches}


def _spmd_line(label: str, rec: dict) -> str:
    return (f"{label}: wall {rec['wall_s']:.4f} s (map {rec['map_s']:.4f} s, exchange "
            f"{rec['exchange_s']:.4f} s, reduce {rec['reduce_s']:.4f} s), slot_cap "
            f"{rec['slot_cap']}, K1 "
            f"{rec['launches']['murmur3_pmod']}, K2 {rec['launches']['partition_histogram']}, "
            f"peak device memory {rec['peak_bytes'] / 2**30:.3f} GiB")


def _timed_spmd(run, barrier=None, warmup: bool = True):
    """A warm-up (unless ``warmup`` is False), then one timed run with the
    launch counts set to 0 just before it (and every rank starting
    together); (answer, wall, stats, launches)."""
    import torch

    if warmup:
        run({})
    if barrier is not None:
        barrier()
    _reset_launches()
    torch.cuda.synchronize()
    st: dict = {}
    t0 = time.perf_counter()
    got = run(st)
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, st, _launches()


def spmd_worker_main(work: str, seed: int) -> int:
    """One worker process of phase 26 (``--spmd-worker``), joined through the
    ``AURON_*`` environment: rank r of two on cuda:0 over a gloo data plane
    runs (a) q93-mesh on both transports, (b) the STRING group-by and (c)
    ``sharded_agg_exchange_step`` on its partitions; then rank 0 runs (d)
    through a world-1 NCCL group. Writes ``rank<r>.pkl`` under ``work``."""
    import pickle
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.parallel import exchange, multihost

    assert multihost.initialize_from_env(device="cuda")
    rank, world = multihost.process_info()
    # the ranks share the host's cores: oversubscribed intra-op pools stall
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    res: dict = {"rank": rank, "world": world, "backend": multihost.backend()}
    mesh = multihost.global_mesh(SPMD_PARTS // world, device="cuda:0")
    res["local_parts"] = mesh.local_parts
    # (a) q93-mesh: the fact table from the parent's files
    t0 = time.perf_counter()
    names = tpcds.STORE_SALES_SCHEMA.names
    cols = {n: np.load(os.path.join(work, f"fact_{n}.npy"), mmap_mode="r") for n in names}
    valid = {n: np.load(os.path.join(work, f"fact_{n}.valid.npy"), mmap_mode="r")
             for n in names if os.path.exists(os.path.join(work, f"fact_{n}.valid.npy"))}
    data = types.SimpleNamespace(store_sales=tpcds.Table(tpcds.STORE_SALES_SCHEMA, cols,
                                                         valid))
    ingested = tpcds.ingest_q93(data, SPMD_PARTS, mesh.device, only=mesh.local_parts)
    torch.cuda.synchronize()
    res["ingest_s"] = time.perf_counter() - t0
    res["q93"] = {}
    for mode in SPMD_Q93_MODES:
        runs = iter(range(2))

        def run(st, mode=mode, runs=runs):
            wd = os.path.join(work, f"q93_{mode}_{next(runs)}") if mode == "file" else None
            return tpcds.run_q93_mesh(conf={**SPMD_Q93_CONF, "exchange.mode": mode},
                                      stats=st, ingested=ingested, mesh=mesh, work_dir=wd)

        got, wall, st, launches = _timed_spmd(run, multihost.barrier, mode == "file")
        res["q93"][mode] = {"pieces": got, **_spmd_mesh_record(wall, st, launches)}
    del ingested
    # (b) the STRING group-by over as many rows as the fact
    n_rows = len(cols[names[0]])
    parts, _ = _spmd_dict_parts(n_rows, SPMD_PARTS, seed, mesh.device, mesh.local_parts)
    _, plan = _spmd_dict_plan(SPMD_PARTS)

    def run_dict(st):
        outs = tpcds._run_mesh(plan, {"fact": parts}, SPMD_PARTS, mesh.device,
                               {"exchange.mode": "mesh"}, st, mesh)
        return {p: tpcds.collect(outs[p]) for p in mesh.local_parts}

    got, wall, st, launches = _timed_spmd(run_dict, multihost.barrier)
    res["dict"] = {"pieces": got, **_spmd_mesh_record(wall, st, launches)}
    del parts
    # (c) sharded_agg_exchange_step on this rank's [L, 2^22] rows
    lo, hi = mesh.local_parts[0], mesh.local_parts[-1] + 1
    args = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(mesh.device)
            for a in _spmd_agg_inputs(seed)]
    step = exchange.sharded_agg_exchange_step(mesh, SPMD_AGG_SLOT_CAP)
    out, wall, _, launches = _timed_spmd(lambda st: step(*args), multihost.barrier)
    res["agg"] = {"digests": _digests(out[:4]), "overflow": int(out[4]), "wall_s": wall,
                  "launches": launches,
                  "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)}
    del args, out
    # (d) the data plane over NCCL with one rank: a world-1 NCCL group of
    # rank 0 (every rank takes part in making it; the only NCCL code one
    # card can run)
    nccl1 = dist.new_group(ranks=[0], backend="nccl")
    if rank == 0:
        arrays, sel, pid = _spmd_nccl_inputs(seed)
        args = ([torch.from_numpy(a).to(mesh.device) for a in arrays],
                torch.from_numpy(sel).to(mesh.device), torch.from_numpy(pid).to(mesh.device))
        run = (lambda: exchange.all_to_all_rows(*args, SPMD_PARTS, SPMD_NCCL_SLOT_CAP, nccl1))
        ms = _event_ms(run, 3, warmup=1)
        recv, rsel, overflow = run()
        res["nccl"] = {"digests": _digests([*recv, rsel]), "overflow": int(overflow),
                       "ms": ms, "backend": dist.get_backend(nccl1),
                       "world": dist.get_world_size(nccl1)}
        del args, recv, rsel
        dist.destroy_process_group(nccl1)
    multihost.barrier()
    multihost.shutdown()
    res["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "auron_tpu"))
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    assert not res["foreign_modules"], res["foreign_modules"]
    return 0


def _spawn_workers(world: int, work: str, seed: int) -> list:
    """Run ``world`` workers (this script with --spmd-worker, a gloo data
    plane) to their end, each waited on with a timeout (then every one
    killed); fail if any fails. Returns their pickled results in rank
    order."""
    import pickle
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, AURON_COORDINATOR=f"127.0.0.1:{port}",
                   AURON_NUM_PROCS=str(world), AURON_PROC_ID=str(r),
                   AURON_DIST_BACKEND="gloo", PYTHONUNBUFFERED="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--spmd-worker", "--spmd-dir", work,
             "--seed", str(seed)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPMD_WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"phase 26: workers hung past {SPMD_WORKER_TIMEOUT_S} s; "
                             f"output so far: {logs}")
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.strip().splitlines()[-40:])
        print(f"  worker rank {r} (exit {p.returncode}):" + (f"\n{tail}" if tail else ""),
              flush=True)
        assert p.returncode == 0, f"phase 26: worker rank {r} failed"
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _bits_equal(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == np.ascontiguousarray(b).tobytes()
    return bool(np.array_equal(a, b))


def run_spmd_phase(data, fact, seed: int, smi: str) -> dict:
    """Phase 26: multi-process SPMD (``parallel/multihost.py``, the SPMD
    ``MeshQueryDriver``, the cross-process exchange, the step functions):
    the one-process runs on the card here, then two worker processes on the
    card (gloo data plane, 2 of P = 4 partitions each) for legs (a)-(c) and
    rank 0 over a world-1 NCCL group for (d); every leg equal to its
    one-process run bit for bit and to its oracle."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.parallel import exchange
    from auron_tpu_torch.parallel.mesh import make_mesh

    print(f"phase 26 on {smi}", flush=True)
    work = tempfile.mkdtemp(prefix="auron_spmd_")
    out: dict = {"one_process": {}}
    try:
        # the fact table for the workers (they read it; they do not generate)
        t0 = time.perf_counter()
        ss = data.store_sales
        for n in ss.schema.names:
            np.save(os.path.join(work, f"fact_{n}.npy"), ss.columns[n])
            if n in ss.valid:
                np.save(os.path.join(work, f"fact_{n}.valid.npy"), ss.valid[n])
        out["files_s"] = time.perf_counter() - t0
        # (a) one process: q93-mesh at P = 4 on both transports
        ingested = tpcds.ingest_q93(data, SPMD_PARTS, device="cuda", fact=fact)
        want93 = _oracle("q93", data)
        for mode in SPMD_Q93_MODES:
            conf = {**SPMD_Q93_CONF, "exchange.mode": mode}
            got, wall, st, launches = _timed_spmd(lambda s, conf=conf: tpcds.run_q93_mesh(
                n_parts=SPMD_PARTS, device="cuda", conf=conf, stats=s, ingested=ingested),
                warmup=mode == "file")
            _assert_q93(got, want93)
            out["one_process"][f"q93 ({mode})"] = {"answer": got,
                                                   **_spmd_mesh_record(wall, st, launches)}
        del ingested
        # (b) one process: the STRING group-by
        parts, dict_oracle = _spmd_dict_parts(data.fact_rows(), SPMD_PARTS, seed, "cuda")
        _, plan = _spmd_dict_plan(SPMD_PARTS)

        def run_dict(st):
            outs = tpcds._run_mesh(plan, {"fact": parts}, SPMD_PARTS, "cuda",
                                   {"exchange.mode": "mesh"}, st)
            return {p: tpcds.collect(outs[p]) for p in range(SPMD_PARTS)}

        dict_pieces, wall, st, launches = _timed_spmd(run_dict)
        out["one_process"]["dict"] = _spmd_mesh_record(wall, st, launches)
        del parts
        # (c) one process: the stacked [4, 2^22] step
        args = [torch.from_numpy(a).cuda() for a in _spmd_agg_inputs(seed)]
        step = exchange.sharded_agg_exchange_step(make_mesh(SPMD_PARTS, "cuda"),
                                                  SPMD_AGG_SLOT_CAP)
        agg, wall, _, launches = _timed_spmd(lambda st: step(*args))
        L = SPMD_PARTS // SPMD_RANKS
        agg_want = [_digests([t[r * L:(r + 1) * L] for t in agg[:4]]) for r in range(SPMD_RANKS)]
        out["one_process"]["agg"] = {"wall_s": wall, "launches": launches,
                                     "overflow": int(agg[4])}
        del args, agg
        # (d) one process: the relayout of the stacked [4, 2^22] rows
        arrays, sel, pid = _spmd_nccl_inputs(seed)
        dargs = ([torch.from_numpy(a).cuda() for a in arrays], torch.from_numpy(sel).cuda(),
                 torch.from_numpy(pid).cuda())
        relayout = (lambda: exchange.all_to_all_rows(*dargs, SPMD_PARTS, SPMD_NCCL_SLOT_CAP))
        relayout_ms = _event_ms(relayout, 3)
        recv, rsel, d_overflow = relayout()
        d_want = _digests([*recv, rsel])
        out["one_process"]["relayout"] = {"ms": relayout_ms, "overflow": int(d_overflow)}
        del dargs, recv, rsel
        torch.cuda.empty_cache()
        for label, rec in out["one_process"].items():
            if "map_s" in rec:
                print("  " + _spmd_line(f"one process {label}", rec), flush=True)

        # (a)-(c) across two worker processes on the card
        t0 = time.perf_counter()
        ranks = _spawn_workers(SPMD_RANKS, work, seed)
        out["pair_s"] = time.perf_counter() - t0
        print(f"  two workers from start to results {out['pair_s']:.1f} s (fact files written "
              f"in {out['files_s']:.2f} s, read back in {ranks[0]['ingest_s']:.2f} and "
              f"{ranks[1]['ingest_s']:.2f} s)", flush=True)
        for res in ranks:
            assert res["backend"] == "gloo" and res["foreign_modules"] == [], res
        for mode in SPMD_Q93_MODES:
            pieces = {}
            for res in ranks:
                rec = res["q93"][mode]
                assert rec["mode"] == mode, rec["mode"]
                pieces.update(rec["pieces"])
                print("  " + _spmd_line(f"rank {res['rank']} q93-mesh ({mode})", rec), flush=True)
            got = tpcds.q93_mesh_answer(pieces)
            want = out["one_process"][f"q93 ({mode})"]["answer"]
            assert sorted(pieces) == list(range(SPMD_PARTS)), sorted(pieces)
            for k in want:
                assert _bits_equal(got[k], want[k]), (f"q93-mesh ({mode}) {k}", got, want)
            _assert_q93(got, want93)
            for res in ranks:  # K1 and K2 once a local map shard
                launched = res["q93"][mode]["launches"]
                assert launched["murmur3_pmod"] == launched["partition_histogram"] == \
                    SPMD_PARTS // SPMD_RANKS, (mode, res["rank"], launched)
        got_dict = {}
        for res in ranks:
            got_dict.update(res["dict"]["pieces"])
            print("  " + _spmd_line(f"rank {res['rank']} STRING group-by", res["dict"]),
                  flush=True)
            assert res["dict"]["launches"]["partition_histogram"] == SPMD_PARTS // SPMD_RANKS
        for p in range(SPMD_PARTS):
            for k in dict_pieces[p]:
                assert _bits_equal(got_dict[p][k], dict_pieces[p][k]), ("dict", p, k)
        combined = {c: (int(s), int(n)) for p in range(SPMD_PARTS)
                    for c, s, n in zip(*(got_dict[p][k] for k in ("cat", "s", "c")))}
        assert len(combined) == sum(len(got_dict[p]["cat"]) for p in range(SPMD_PARTS))
        assert combined == dict_oracle, (combined, dict_oracle)
        for res in ranks:
            rec = res["agg"]
            assert rec["digests"] == agg_want[res["rank"]], f"agg rank {res['rank']} differs"
            assert rec["overflow"] == out["one_process"]["agg"]["overflow"] == 0
            # one K1 launch routes the groups of every local shard
            assert rec["launches"]["murmur3_pmod"] == 1, rec["launches"]
            print(f"  rank {res['rank']} sharded_agg_exchange_step [{L}, {SPMD_AGG_ROWS}]: "
                  f"wall {rec['wall_s']:.4f} s (one process [{SPMD_PARTS}, {SPMD_AGG_ROWS}]: "
                  f"{out['one_process']['agg']['wall_s']:.4f} s), K1 "
                  f"{rec['launches']['murmur3_pmod']}, overflow {rec['overflow']}, peak "
                  f"{rec['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        for res in ranks:  # the answers stay here; the records keep the figures
            res["dict"].pop("pieces")
            for rec in res["q93"].values():
                rec.pop("pieces")
        out["ranks"] = ranks
        # (d) the data plane over NCCL, one rank
        rec = ranks[0]["nccl"]
        assert (rec["backend"], rec["world"]) == ("nccl", 1), rec
        assert rec["digests"] == d_want and rec["overflow"] == int(d_overflow) > 0, rec
        print(f"  world-1 NCCL all_to_all_rows [{SPMD_PARTS}, {SPMD_NCCL_ROWS}] x 4 columns: "
              f"{rec['ms']:.3f} ms against the one-process relayout's {relayout_ms:.3f} ms, "
              f"bit for bit, overflow {rec['overflow']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {
        **{f"spmd q93-mesh ({m}) rank {r['rank']}": r["q93"][m]["launches"]
           for r in ranks for m in SPMD_Q93_MODES},
        **{f"spmd STRING group-by rank {r['rank']}": r["dict"]["launches"] for r in ranks},
        **{f"spmd sharded_agg_exchange_step rank {r['rank']}": r["agg"]["launches"]
           for r in ranks}}
    for rec in out["one_process"].values():
        rec.pop("answer", None)
    return out


#: what the second process hands back, in phase order
#: the class gate's scale: the reference's default
GATE_SF = 0.05


def run_class_gate_phase() -> dict:
    """Phase 27: the port's ``tpcds.run_gate`` on the card at the
    reference's default scale, every record printed; fails unless every
    case passes. Also the run's kernel launches and its task count."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.models import tpcds

    tasks = []
    start = api.call_native

    def counted(task, *args, **kwargs):
        tasks.append(len(task))
        return start(task, *args, **kwargs)

    _reset_launches()
    api.call_native = counted
    t0 = time.perf_counter()
    try:
        res = tpcds.run_gate(sf=GATE_SF, device="cuda")
    finally:
        api.call_native = start
    wall = time.perf_counter() - t0
    launches = _launches()
    failed = [(n, e) for n, ok, e, _ in res if not ok]
    print(f"class gate (SF {GATE_SF}): {len(res) - len(failed)}/{len(res)} PASS in {wall:.1f} s, "
          f"{len(tasks)} tasks from TaskDefinition bytes ({sum(tasks):,} B), launches "
          f"{launches}", flush=True)
    assert len(res) == 42 and not failed, ("class gate", failed)
    return {"wall_s": wall, "launches": launches, "tasks": len(tasks), "task_bytes": sum(tasks),
            "records": [{"name": n, "ok": ok, "error": e, "seconds": s} for n, ok, e, s in res]}


LATE_RESULTS = ("plan_ir", "convert", "files", "basket", "udf_shuffle", "sql", "serve", "stream",
                "spmd", "decimal", "generate")
#: the file in the second process's work directory whose existence says
#: that the first process has ended its phases (phase 24 waits for it)
PARENT_IDLE_FILE = "parent.idle"
#: how long the parent waits for the second process past its own phases
LATE_TIMEOUT_S = 900


def run_late_phases(data, sf: float, seed: int, smi: str, phase_done, profile: bool,
                    parent_idle) -> dict:
    """Phases 18-23, 25 (b, c), 26, 14 and 16 over ``data``, then, once
    ``parent_idle()`` returns (the first process has ended its phases),
    phase 25 (a) and phase 24; {name: result} for LATE_RESULTS."""
    from auron_tpu_torch.models import tpcds

    # 18. the plan IR without google.protobuf: q42, q93 and q3 from bytes,
    # then the C host
    fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
    plan_ir = run_plan_ir_phase(data, fact, seed, kernels_checked=True)
    phase_done("18")

    # 19. the host-plan converters: q42, q93, q3 and the range sort from
    # host-plan JSON, the converted q93 on the mesh and from the C host
    convert = run_convert_phase(data, fact, seed, kernels_checked=True)
    del fact
    phase_done("19")

    # 20. the Parquet and ORC sinks and scans: the tables written by
    # converted plans, then q42, q93 and q3 read from those files (after
    # phase 19, which fails if pyarrow was loaded)
    files = run_files_phase(data, seed, kernels_checked=True, convert=convert)
    phase_done("20")

    # 21. the customer-basket class: collect_set / collect_list states
    # through the file shuffle, STRUCT and MAP columns out of the card
    basket = run_collect_phase(data, seed, kernels_checked=True)
    phase_done("21")

    # 22. the host callbacks and the shuffle tail: the codecs, v1 blocks, the
    # remote shuffle service, concurrent task slots, the UDF class (after
    # phases 19-21: it loads pyarrow)
    udf_shuffle = run_udf_shuffle_phase(data, seed, kernels_checked=True)
    phase_done("22")

    # 23. the SQL front end: the gate's 24 TPC-DS texts compiled to plan IR
    # and run through the planned-exchange driver and a collect task
    sql, sql_shared = run_sql_phase(data, seed, kernels_checked=True)
    phase_done("23")

    # 25 (b, c). streaming: two views served through POST /stream, planned
    # kafka_scan tasks with a keyed exchange (the gate, (a), runs below)
    stream = run_stream_phase(None, EXCHANGE_EVENTS)
    phase_done("25 (b, c)")

    # 26. multi-process SPMD: q93-mesh, a STRING group-by and the sharded
    # aggregation step across two worker processes on the card, the NCCL
    # data plane with one rank
    fact = tpcds.to_batches(data.store_sales, SPMD_PARTS, device="cuda")
    spmd = run_spmd_phase(data, fact, seed, smi)
    del fact
    phase_done("26")

    # 14. the decimal paths: q9b, q3 and q42 with the money type, windowed
    # over decimal revenues
    decimal = run_decimal_classes(data, profile)
    phase_done("14")

    # 16. the generate classes: the 42nd class and the explode over the
    # whole fact
    gen = run_generate_phase(data, profile)
    phase_done("16")

    # 24. serving: the 24 corpus texts served to concurrent clients and
    # over POST /sql, each query under its own trace; its serial and
    # concurrent legs are timed with the first process's phases ended
    parent_idle()
    phase_done("24 (waited for the first process)")

    # 25 (a). the stream gate at the reference's floor: its fused and eager
    # legs, like phase 24's, timed with the first process's phases ended
    run_stream_gate(stream, STREAM_GATE_EVENTS)
    phase_done("25 (a)")

    serve = run_serve_phase(data, sf, seed, SERVE_CLIENTS, sql=sql,
                            shared=sql_shared, ab_modes=SERVE_AB_MODES_IN_SCRIPT)
    del sql_shared
    phase_done("24")

    return dict(zip(LATE_RESULTS, (plan_ir, convert, files, basket, udf_shuffle, sql, serve,
                                   stream, spmd, decimal, gen)))


def _start_late(sf: float, seed: int, profile: bool) -> dict:
    """Start phases 14, 16 and 18-26 in a second process (this script with
    --late-phases, the kernels already built), its output to files in a
    work directory of its own, in a session of its own so that
    ``_stop_late`` stops its worker processes too."""
    import tempfile

    work = tempfile.mkdtemp(prefix="auron_smoke_late_")
    out = open(os.path.join(work, "late.log"), "w")
    err = open(os.path.join(work, "late.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--late-phases", "--late-dir", work,
         "--sf", repr(sf), "--seed", str(seed), "--parent-pid", str(os.getpid())]
        + (["--profile"] if profile else []),
        env=dict(os.environ, PYTHONUNBUFFERED="1"), stdout=out, stderr=err,
        start_new_session=True)
    out.close()
    err.close()
    print(f"phases 14, 16 and 18-26 started in a second process (pid {proc.pid}) beside "
          f"phases 3-13, 15, 17 and 27", flush=True)
    return {"proc": proc, "work": work, "t0": time.perf_counter()}


def _stop_late(late: dict) -> None:
    """Kill the second process's session if it still runs, and remove its
    work directory."""
    import shutil
    import signal

    proc = late["proc"]
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    shutil.rmtree(late["work"], ignore_errors=True)


def _join_late(late: dict) -> dict:
    """Wait (at most LATE_TIMEOUT_S) for the second process, print its
    output, and fail unless it exited 0; returns what it handed back."""
    import pickle

    proc, work = late["proc"], late["work"]
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=LATE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    with open(os.path.join(work, "late.log")) as f:
        log = f.read()
    print(f"--- phases 14, 16, 18-26 (second process, {time.perf_counter() - late['t0']:.1f} s "
          f"from start to exit, {time.perf_counter() - t_wait:.1f} s waited for after phase "
          f"27):",
          flush=True)
    print(log.rstrip("\n"), flush=True)
    print("--- end of the second process's output", flush=True)
    if rc != 0:
        with open(os.path.join(work, "late.err")) as f:
            tail = "\n".join(f.read().strip().splitlines()[-60:])
        raise AssertionError(f"phases 14, 16, 18-26: the second process "
                             f"{'hung past %d s' % LATE_TIMEOUT_S if rc is None else 'exited %d' % rc}"
                             f"; its standard error ends:\n{tail}")
    with open(os.path.join(work, "late.pkl"), "rb") as f:
        return pickle.load(f)


def _follow_parent(parent_pid: int) -> None:
    """End this process's session when the parent ends: the kernel sends
    SIGTERM when the parent exits (PR_SET_PDEATHSIG), and the handler kills
    the session (this process and the phases' own worker processes)."""
    import ctypes
    import signal

    signal.signal(signal.SIGTERM, lambda *_: os.killpg(os.getpgrp(), signal.SIGKILL))
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)  # 1 = PR_SET_PDEATHSIG
    if os.getppid() != parent_pid:  # the parent ended before the call above
        os.killpg(os.getpgrp(), signal.SIGKILL)


def late_main(work: str, sf: float, seed: int, parent_pid: int, profile: bool) -> int:
    """``chip_smoke.py --late-phases``: phases 14, 16 and 18-26 as the whole
    script's second process. The parent built the kernels; this process loads them,
    makes the data from the same seed, runs the phases and hands their
    results (with its phase seconds) back in ``late.pkl``."""
    import pickle

    import torch

    _follow_parent(parent_pid)
    assert torch.cuda.is_available(), "the second process sees no card"
    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock = [time.perf_counter()]
    phase_s: dict = {}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    cuda_build.build_all()
    data = tpcds.generate(sf, seed)
    phase_done("18-26 set-up (kernels loaded, the data made)")

    def parent_idle() -> None:
        while not os.path.exists(os.path.join(work, PARENT_IDLE_FILE)):
            time.sleep(0.1)

    results = run_late_phases(data, sf, seed, smi, phase_done, profile, parent_idle)
    report_graph_cache()
    try:
        blob = pickle.dumps({"results": results, "phase_s": phase_s})
    except (pickle.PicklingError, TypeError, AttributeError):
        # what chip_smoke.json keeps of them: numbers, strings, lists, dicts
        plain = json.loads(json.dumps(results, default=_jsonable))
        blob = pickle.dumps({"results": plain, "phase_s": phase_s})
    with open(os.path.join(work, "late.pkl"), "wb") as f:
        f.write(blob)
    return 0


def _jsonable(o):
    """numpy scalars as Python numbers, anything else as its text."""
    return o.item() if type(o).__module__ == "numpy" and getattr(o, "ndim", None) == 0 else str(o)


def report_graph_cache() -> None:
    """Print the CUDA-graph cache's resident bytes, graphs and evictions
    over the script, and fail if it holds more than its cap (a quarter of
    the memory manager's budget)."""
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.plan import fusion

    cache = fusion._GRAPHS
    cap = MemManager.get().budget // fusion.GRAPH_BUDGET_SHARE
    print(f"graph cache at the end: {cache.pool_bytes() / 2**20:.1f} MiB in "
          f"{len(cache._graphs)} graphs (cap {cap / 2**20:.1f} MiB), "
          f"{cache.evictions} evictions over the script", flush=True)
    assert cache.pool_bytes() <= cap, "the graph cache passed its cap"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=8.0, help="scale factor (default 8)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one q42, q93 and q3 run (device busy share, top kernels)")
    ap.add_argument("--window-only", action="store_true",
                    help="run phases 1, 2 and 11 only (no kernel table, no status line)")
    ap.add_argument("--join-tail-only", action="store_true",
                    help="run phases 1, 2 and 13 only (no kernel table, no status line; "
                         "with --profile, traces of q33, three sweep cases, q42 and q3)")
    ap.add_argument("--decimal-only", action="store_true",
                    help="run phases 1, 2 and 14 only (no kernel table, no status line; "
                         "with --profile, traces of the decimal q3 and q42)")
    ap.add_argument("--fusion-only", action="store_true",
                    help="run phases 1, 2 and 15 only (no kernel table, no status line; "
                         "with --profile, every A/B path profiled each way)")
    ap.add_argument("--generate-only", action="store_true",
                    help="run phases 1, 2 and 16 only (no kernel table, no status line; "
                         "with --profile, both generate classes profiled)")
    ap.add_argument("--bridge-only", action="store_true",
                    help="run phases 1, 2 and 17 only (no kernel table, no status line; "
                         "with --profile, q42 and q93 through the boundary profiled)")
    ap.add_argument("--plan-ir-only", action="store_true",
                    help="run phases 1, 2 and 18 only (no kernel table, no status line)")
    ap.add_argument("--convert-only", action="store_true",
                    help="run phases 1, 2 and 19 only (no kernel table, no status line)")
    ap.add_argument("--files-only", action="store_true",
                    help="run phases 1, 2 and 20 only (no kernel table, no status line)")
    ap.add_argument("--collect-only", action="store_true",
                    help="run phases 1, 2 and 21 only (no kernel table, no status line)")
    ap.add_argument("--udf-shuffle-only", action="store_true",
                    help="run phases 1, 2 and 22 only (no kernel table, no status line)")
    ap.add_argument("--sql-only", action="store_true",
                    help="run phases 1, 2 and 23 only (no kernel table, no status line)")
    ap.add_argument("--serve-only", action="store_true",
                    help="run phases 1, 2 and 24 only (no kernel table, no status line)")
    ap.add_argument("--stream-only", action="store_true",
                    help="phases 1, 2 and 25 (streaming) only, at 1,000,000 gate events and "
                         "4,000,000 exchange events")
    ap.add_argument("--spmd-only", action="store_true",
                    help="phases 1, 2 and 26 (multi-process SPMD) only")
    ap.add_argument("--gate-only", action="store_true",
                    help="phases 1, 2 and 27 (the class gate) only")
    ap.add_argument("--spmd-worker", action="store_true",
                    help="run as one worker process of phase 26 (the parent starts them)")
    ap.add_argument("--spmd-dir", help="phase 26's work directory (with --spmd-worker)")
    ap.add_argument("--late-phases", action="store_true",
                    help="run phases 14, 16 and 18-26 as the whole script's second process "
                         "(the parent starts it)")
    ap.add_argument("--late-dir", help="the second process's work directory")
    ap.add_argument("--parent-pid", type=int, help="the parent's pid (with --late-phases)")
    ap.add_argument("--time-sorts", action="store_true",
                    help="only build and time the bitonic kernels at the sort shapes "
                         "(one JSON line, no status line)")
    args = ap.parse_args(argv)
    if args.time_sorts:
        return time_sorts_main()
    if args.spmd_worker:
        return spmd_worker_main(args.spmd_dir, args.seed)
    if args.late_phases:
        return late_main(args.late_dir, args.sf, args.seed, args.parent_pid, args.profile)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    clock = [time.perf_counter()]
    from auron_tpu_torch.ops import cuda_build

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, cuda {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {build_s})", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    phase_s: dict = {}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    phase_done("1-2")
    from auron_tpu_torch.models import tpcds

    if args.window_only:
        data = tpcds.generate(args.sf, args.seed)
        window = run_window_classes(data)
        phase_done("11")
        if args.profile:
            profile_window_classes(data, window)
        return 0

    if args.join_tail_only:
        data = tpcds.generate(args.sf, args.seed)
        run_join_tail_phase(data, args.profile)
        phase_done("13")
        return 0

    if args.decimal_only:
        data = tpcds.generate(args.sf, args.seed)
        run_decimal_classes(data, args.profile)
        phase_done("14")
        return 0

    if args.fusion_only:
        data = tpcds.generate(args.sf, args.seed)
        fused = run_fusion_phase(data, args.profile)
        phase_done("15")
        report_graph_cache()
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_fusion.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "fusion": fused, "phase_s": phase_s},
                      f, indent=1)
        return 0

    if args.generate_only:
        data = tpcds.generate(args.sf, args.seed)
        gen = run_generate_phase(data, args.profile)
        phase_done("16")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_generate.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "generate": gen, "phase_s": phase_s},
                      f, indent=1)
        return 0

    if args.bridge_only:
        data = tpcds.generate(args.sf, args.seed)
        bridge = run_bridge_phase(data, args.profile)
        phase_done("17")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_bridge.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "bridge": bridge, "phase_s": phase_s},
                      f, indent=1)
        return 0

    if args.plan_ir_only:
        data = tpcds.generate(args.sf, args.seed)
        fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
        plan_ir = run_plan_ir_phase(data, fact, args.seed, kernels_checked=False)
        phase_done("18")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_plan_ir.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "plan_ir": plan_ir,
                       "phase_s": phase_s}, f, indent=1)
        return 0

    if args.convert_only:
        data = tpcds.generate(args.sf, args.seed)
        fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
        convert = run_convert_phase(data, fact, args.seed, kernels_checked=False)
        phase_done("19")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_convert.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "convert": convert,
                       "phase_s": phase_s}, f, indent=1)
        return 0

    if args.files_only:
        data = tpcds.generate(args.sf, args.seed)
        files = run_files_phase(data, args.seed, kernels_checked=False, convert=None)
        phase_done("20")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_files.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "files": files, "phase_s": phase_s},
                      f, indent=1)
        return 0

    if args.collect_only:
        data = tpcds.generate(args.sf, args.seed)
        basket = run_collect_phase(data, args.seed, kernels_checked=False)
        phase_done("21")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_collect.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "basket": basket,
                       "phase_s": phase_s}, f, indent=1)
        return 0

    if args.udf_shuffle_only:
        data = tpcds.generate(args.sf, args.seed)
        udf_shuffle = run_udf_shuffle_phase(data, args.seed, kernels_checked=False)
        phase_done("22")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_udf_shuffle.json"),
                  "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "udf_shuffle": udf_shuffle,
                       "phase_s": phase_s}, f, indent=1)
        return 0

    if args.sql_only:
        data = tpcds.generate(args.sf, args.seed)
        sql, _ = run_sql_phase(data, args.seed, kernels_checked=False)
        phase_done("23")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_sql.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "sql": sql, "phase_s": phase_s},
                      f, indent=1, default=str)
        return 0

    if args.serve_only:
        data = tpcds.generate(args.sf, args.seed)
        serve = run_serve_phase(data, args.sf, args.seed, SERVE_CLIENTS, profile=True)
        phase_done("24")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_serve.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "serve": serve, "phase_s": phase_s},
                      f, indent=1, default=str)
        return 0

    if args.spmd_only:
        check_partition_kernel(args.seed)
        check_histogram_kernel(args.seed)
        data = tpcds.generate(args.sf, args.seed)
        fact = tpcds.to_batches(data.store_sales, SPMD_PARTS, device="cuda")
        spmd = run_spmd_phase(data, fact, args.seed, smi)
        phase_done("26")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_spmd.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "spmd": spmd, "phase_s": phase_s},
                      f, indent=1, default=str)
        return 0

    if args.gate_only:
        gate = run_class_gate_phase()
        phase_done("27")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_gate.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "class_gate": gate,
                       "phase_s": phase_s}, f, indent=1, default=str)
        return 0

    if args.stream_only:
        check_partition_kernel(args.seed)
        stream = run_stream_phase(STREAM_GATE_EVENTS_ONLY, EXCHANGE_EVENTS_ONLY)
        phase_done("25")
        os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke_stream.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "stream": stream, "phase_s": phase_s},
                      f, indent=1, default=str)
        return 0

    # 3 (timing). the kernels, plain versions and library calls timed with
    # the card to this process alone, before the second process starts
    timing = time_kernels(args.seed)
    timing["murmur3_pmod"] = time_partition_kernel(args.seed)
    timing["partition_histogram"] = time_histogram_kernel(args.seed)
    phase_done("3 (timing)")

    # 14, 16 and 18-26 start in a second process (this script with
    # --late-phases) and run beside phases 3-13, 15, 17 and 27 on the card
    late_proc = _start_late(args.sf, args.seed, args.profile)
    try:
        return _early_phases_and_report(args, kind, smi, build_s, timing, phase_s, phase_done,
                                        late_proc)
    finally:
        _stop_late(late_proc)


def _early_phases_and_report(args, kind, smi, build_s, timing, phase_s, phase_done,
                             late_proc) -> int:
    """The whole script after its build and the kernel timing: phases 3-13,
    15, 17 and 27 here, 14, 16 and 18-26 from the second process (its phase
    24 once this one is idle), phase 28 and the status line."""
    import torch

    from auron_tpu_torch.models import tpcds

    # 3. kernels against their plain versions
    checks = check_kernels(args.seed)
    checks["murmur3_pmod"] = check_partition_kernel(args.seed)
    checks["partition_histogram"] = check_histogram_kernel(args.seed)
    phase_done("3")

    # 4. the data, once; q42-class end to end
    t0 = time.perf_counter()
    data = tpcds.generate(args.sf, args.seed)
    t_gen = time.perf_counter() - t0
    q42, ingested = run_q42(data, args.sf, t_gen)
    if args.profile:
        q42["profile"] = profile_q42(ingested)
    del ingested
    phase_done("4")

    # 5-6. the two-stage queries over one 4-partition ingest of the fact table
    t0 = time.perf_counter()
    fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
    torch.cuda.synchronize()
    print(f"fact table in 4 partitions on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    q93 = run_q93(data, fact)
    q3 = run_q3(data, fact)
    if args.profile:
        q93["profile"] = profile_run("q93", lambda: tpcds.run_q93_class(
            device="cuda", ingested=tpcds.ingest_q93(data, 4, device="cuda", fact=fact)))
        q3["profile"] = profile_run("q3", lambda: tpcds.run_q3_class(
            device="cuda", ingested=tpcds.ingest_q3(data, 4, device="cuda", fact=fact)))
    phase_done("5-6")

    # 7. the same queries through the planned-exchange driver, P = 4
    q93_mesh = run_mesh("q93", data, fact)
    q3_mesh = run_mesh("q3", data, fact)
    if args.profile:
        for mode in ("mesh", "file"):
            conf = {"exchange.mode": mode}
            q93_mesh[mode]["profile"] = profile_run(f"q93-mesh ({mode})", lambda: (
                tpcds.run_q93_mesh(device="cuda", conf=conf, ingested=tpcds.ingest_q93(
                    data, 4, device="cuda", fact=fact))))
            q3_mesh[mode]["profile"] = profile_run(f"q3-mesh ({mode})", lambda: (
                tpcds.run_q3_mesh(device="cuda", conf=conf, ingested=tpcds.ingest_q3(
                    data, 4, device="cuda", fact=fact))))
    phase_done("7")

    # 8. the six gate classes of this slice over the same fact partitions
    oracles = _oracles({name: (lambda n=name: _oracle(n, data))
                        for name in dict.fromkeys(name for _, name, _, _ in GATE_RUNS)})
    gate = run_gate_classes(data, fact, oracles)
    if args.profile:
        for label, name, conf, _ in GATE_RUNS:
            ing = _gate_inputs(name, data, fact)  # set-up, outside the profiled run
            gate[label]["profile"] = profile_run(label, lambda: getattr(
                tpcds, f"run_{name}_class")(device="cuda", conf=conf, ingested=ing))
    phase_done("8")

    # 9. sort-merge join stages through the planned-exchange driver
    q72_mesh = run_q72_mesh_phase(data, fact, oracles["q72"])
    # the skew plan's fact rows scale with the SF: 8,388,608 at SF 8
    skew_rows = int((1 << 20) * args.sf)
    skew = run_skew_phase(skew_rows)
    if args.profile:
        ing = tpcds.ingest_q72(data, 4, device="cuda", fact=fact)
        for mode in ("mesh", "file"):
            q72_mesh[mode]["profile"] = profile_run(f"q72-mesh ({mode})", lambda: (
                tpcds.run_q72_mesh(device="cuda", conf={"exchange.mode": mode}, ingested=ing)))
        sf, sd = tpcds.skew_data(skew_rows, 0.7)
        per = (skew_rows + 3) // 4
        ing = {"skew_l": tpcds.to_batches(sf, 4, per, device="cuda"),
               "skew_r": tpcds.to_batches(sd, 4, per, device="cuda")}
        skew["on"]["profile"] = profile_run("skew join (split on)", lambda: (
            tpcds.run_skew_join(device="cuda", ingested=ing)))
        del ing
    phase_done("9")

    # 10. the expression-tail and join-tail classes at the same scale
    tail = run_tail_classes(data, fact)
    if args.profile:
        for label, name, conf, _ in TAIL_RUNS:
            ing = tpcds.ingest_q3(data, TAIL_PARTITIONS.get(name, 1), device="cuda",
                                  fact=fact if TAIL_PARTITIONS.get(name) == 4 else None)
            tail[label]["profile"] = profile_run(label, lambda: getattr(
                tpcds, f"run_{name}_class")(device="cuda", conf=conf, ingested=ing))
            del ing
    phase_done("10")

    # 11. the window, expand and scalar-subquery classes over the whole fact
    del fact
    window = run_window_classes(data, WINDOW_TIMED_RUNS_IN_SCRIPT)
    if args.profile:
        profile_window_classes(data, window)
    phase_done("11")

    # 12. the spill paths: the row threshold's spills under the default
    # conf, then q67, q72 (build) and q93 under memory budgets
    spill = run_spill_phase(data, gate, tail, q93["launches"]["murmur3_pmod"])
    phase_done("12")

    # 13. the join tail and the compaction boundary: q33 over the whole
    # fact, the join-tail sweep, the predictor A/B
    q33, sweep, ab = run_join_tail_phase(data, args.profile)
    phase_done("13")

    # 15. this slice's A/B (fusion and the incremental aggregate, defaults
    # against every key off) and the probe at full width
    fused = run_fusion_phase(data, args.profile)
    phase_done("15")

    # 17. the host boundary: q42 and q93 with inputs on the card and from
    # host Arrow batches to host answers
    bridge = run_bridge_phase(data, args.profile)
    phase_done("17")

    # 27. the reference's class gate at its default scale, every task from
    # its TaskDefinition bytes
    class_gate = run_class_gate_phase()
    phase_done("27")

    # 14, 16 and 18-26 ran in the second process beside this one's phases;
    # its phase 24 starts now, with this process idle: its log, its results
    open(os.path.join(late_proc["work"], PARENT_IDLE_FILE), "w").close()
    late = _join_late(late_proc)
    phase_done("second process (waited for after 27)")
    phase_s.update(late["phase_s"])
    (plan_ir, convert, files, basket, udf_shuffle, sql, serve, stream,
     spmd, decimal, gen) = (late["results"][k] for k in LATE_RESULTS)

    # 28. every kernel sort and run merge of the main paths, held against the
    # plain network on the card at its own operands
    checks["main_path_sorts"] = {
        **{f"q3-mesh ({m})": q3_mesh[m]["sort_checks"] for m in q3_mesh},
        **{label: gate[label]["sort_checks"] for label in gate},
        **{f"skew join ({k})": skew[k]["sort_checks"] for k in skew},
        **{label: tail[label]["sort_checks"] for label in tail},
        **{name: window[name]["sort_checks"] for name in window},
        **{label: spill[label]["sort_checks"] for label in spill if label != "default"},
        **{label: r["sort_checks"] for label, r in sweep.items()
           if label != "profiles" and r["sort_checks"]},
        **{name: r["sort_checks"] for name, r in decimal.items() if r["sort_checks"]},
        "q42 (plan IR)": plan_ir["sort_checks"],
        "q42 (converted)": convert["sort_checks"],
        "range sort (converted)": convert["range sort (converted)"]["sort_checks"],
        "reads (files)": files["reads"]["sort_checks"],
        "sorted write": files["sorted write"]["sort_checks"],
        "basket": basket["sort_checks"],
        **{f"sql {name}": r["sort_checks"] for name, r in sql["queries"].items()
           if r["sort_checks"]},
        "stream exchange": stream["exchange"]["sort_checks"]}
    sort_err = max(s["max_abs_err"] for v in checks["main_path_sorts"].values() for s in v)
    for name in ("bitonic_sort", "bitonic_merge"):
        checks["max_abs_err"][name] = max(checks["max_abs_err"][name], sort_err)
    # each kernel's launches in the timed run of every main path (counts set
    # to 0 just before each and read just after); K4 launches where a sort
    # is past one cluster: q72 (build), the skew plan, q17 and the window
    # classes past 32,768 rows
    paths = {"q42": q42["launches"], "q93": q93["launches"], "q3": q3["launches"],
             **{f"q93-mesh ({m})": q93_mesh[m]["launches"] for m in q93_mesh},
             **{f"q3-mesh ({m})": q3_mesh[m]["launches"] for m in q3_mesh},
             **{label: gate[label]["launches"] for label in gate},
             **{f"q72-mesh ({m})": q72_mesh[m]["launches"] for m in q72_mesh},
             **{f"skew join ({k})": skew[k]["launches"] for k in skew},
             **{label: tail[label]["launches"] for label in tail},
             **{name: window[name]["launches"] for name in window},
             **{label: spill[label]["launches"] for label in spill if label != "default"},
             "q33": q33["launches"],
             **{f"sweep {label}": r["launches"] for label, r in sweep.items()
                if label != "profiles"},
             **{f"{name} (predictor {r['mode']}, run {i})": r["launches"]
                for name in AB_CLASSES for i, r in enumerate(ab[name])},
             **{name: r["launches"] for name, r in decimal.items()},
             **{f"{name} (fusion {m}, run {i})": r["launches"]
                for name in FUSION_PATHS for m in ("on", "off")
                for i, r in enumerate(fused[name][m]["runs"])},
             **{f"probe class ({m})": fused["probe class"][m]["launches"]
                for m in ("on", "off")},
             **{f"{name} (run {i})": launches for name, r in gen.items()
                for i, launches in enumerate(r["launches_per_run"])},
             **{f"{name} ({mode}, run {i})": run["launches"] for name, r in bridge.items()
                for mode in r if mode not in ("host_bytes", "profile")
                for i, run in enumerate(r[mode]["runs"])},
             **{f"{label} run {i}": run["launches"]
                for src in (plan_ir, plan_ir["c_host"]) for label, r in src.items()
                if isinstance(r, dict) and "runs" in r for i, run in enumerate(r["runs"])},
             **{f"{'q93 (converted, C library)' if label == 'c_host' else label} run {i}":
                run["launches"] for label, r in convert.items()
                if isinstance(r, dict) and "runs" in r for i, run in enumerate(r["runs"])},
             **{f"{name} (files) run {i}": run["launches"]
                for name, r in files["reads"].items() if name != "sort_checks"
                for i, run in enumerate(r["runs"])},
             "sorted write": files["sorted write"]["launches"],
             "class gate": class_gate["launches"],
             **{f"basket run {i}": r["launches"] for i, r in enumerate(basket["runs"])},
             **{label: r["launches"] for label, r in udf_shuffle.items()},
             **{f"sql {name}": r["runs"][-1]["launches"] for name, r in sql["queries"].items()},
             **{f"serve {name} (serial)": v for name, v in serve["launches"]["serial"].items()},
             f"serve ({serve['clients']} clients)": serve["launches"]["concurrent"],
             **stream["launches"], **spmd["launches"]}
    kernels = []
    for name, source, replaces in (
        ("bitonic_sort", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:145"),
        ("bitonic_merge", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:176"),
        ("murmur3_pmod", "auron_tpu_torch/csrc/partition.cu",
         "auron_tpu/ops/pallas_kernels.py:26"),
        ("partition_histogram", "auron_tpu_torch/csrc/partition.cu",
         "auron_tpu/ops/pallas_kernels.py:78"),
    ):
        t = timing[name]
        err = (checks[name]["max_abs_err"] if name in ("murmur3_pmod", "partition_histogram")
               else checks["max_abs_err"][name])
        by_path = {p: v[name] for p, v in paths.items() if v[name]}
        assert by_path, f"{name} launched on no main path"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "launches_by_path": by_path,
        })
    os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s, "checks": checks,
                   "timing": timing, "q42": q42, "q93": q93, "q3": q3, "q93_mesh": q93_mesh,
                   "q3_mesh": q3_mesh, "gate": gate, "q72_mesh": q72_mesh, "skew": skew,
                   "tail": tail, "window": window, "spill": spill, "q33": q33,
                   "join_tail_sweep": sweep, "predictor_ab": ab, "decimal": decimal,
                   "fusion": fused, "generate": gen, "bridge": bridge, "plan_ir": plan_ir,
                   "convert": convert, "files": files, "basket": basket,
                   "udf_shuffle": udf_shuffle, "sql": sql, "serve": serve, "stream": stream,
                   "spmd": spmd, "class_gate": class_gate, "phase_s": phase_s,
                   "kernels": kernels}, f, indent=1, default=str)
    phase_done("28")
    report_graph_cache()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
