"""The port's streaming front end (``auron_tpu_torch/exec/streaming.py``,
``kafka_scan`` in the planner) on the CPU, against the JAX package.

Every case of ``tests/test_streaming_bloom_aqe.py`` on the port, each input
made once (from a seed where it is random) and run through both packages:
the streaming Calc under the startup modes and the error policies, the
protobuf and JSON deserializers, the bloom filter, the AQE statistics of
shuffle index files, ``kafka_scan`` planned from bytes (offsets surfaced
on every exit path, zigzag columns, a bad format refused before the
source is touched). Also:

- the planned keyed exchange of ``models/kafka_exchange.py`` (map tasks
  of ``kafka_scan`` -> filter -> project -> partial aggregate -> hash
  shuffle; reduce tasks of final aggregate -> SortExec) at 3,000 events of
  64 users: the port's answer equals the JAX package's, which runs the
  same plan (K1 and the sort through its own CPU route), and the pandas
  group-by;
- an import guard: importing the port's streaming modules loads neither
  jax, nor the JAX package, nor pyarrow.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.exec import streaming as JS
from auron_tpu.exprs import ir as JIR
from auron_tpu_torch import types as T
from auron_tpu_torch.exec import streaming as S
from auron_tpu_torch.exprs import ir as IR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _schemas(*fields):
    """The same schema in both packages: (name, type name) pairs."""
    return (T.Schema.of(*(T.Field(n, getattr(T, t)) for n, t in fields)),
            JT.Schema.of(*(JT.Field(n, getattr(JT, t)) for n, t in fields)))


CALC = _schemas(("id", "INT64"), ("v", "FLOAT64"), ("s", "STRING"))
PB = _schemas(("id", "INT64"), ("price", "FLOAT64"), ("name", "STRING"))


def _records(n, start=0):
    return [json.dumps({"id": i, "v": i * 1.5, "s": f"u{i % 3}"}).encode()
            for i in range(start, start + n)]


def _calc_pair(make_source):
    """(port output ids, reference output ids, port source, reference source)
    of the same Calc (id >= 3; id, v * 2) over sources ``make_source(mod)``."""
    out = []
    for mod, ir, schema, kw in ((S, IR, CALC[0], {"device": "cpu"}), (JS, JIR, CALC[1], {})):
        src = make_source(mod)
        calc = mod.StreamingCalcExec(
            source=src, deserializer=mod.JsonRowDeserializer(schema), in_schema=schema,
            predicates=[ir.BinaryOp("gteq", ir.col(0), ir.lit(3))],
            projections=[(ir.col(0), "id"), (ir.BinaryOp("mul", ir.col(1), ir.lit(2.0)), "v2")],
            max_batch_records=4, **kw)
        got = {"id": [], "v2": []}
        for b in calc.run():
            d = b.to_pydict()
            got["id"] += d["id"]
            got["v2"] += d["v2"]
        out.append((got, src))
    return out


def test_streaming_calc_earliest():
    (got, src), (want, jsrc) = _calc_pair(
        lambda m: m.MockKafkaSource([_records(5), _records(5, start=5)]))
    assert got == want and sorted(got["id"]) == list(range(3, 10))
    assert got["v2"] == [i * 3.0 for i in got["id"]]
    assert src.offsets() == jsrc.offsets() == {0: 5, 1: 5}


def test_streaming_startup_modes():
    (got, _), (want, _) = _calc_pair(
        lambda m: m.MockKafkaSource([_records(5)], startup_mode=m.LATEST))
    assert got == want == {"id": [], "v2": []}
    (got, _), (want, _) = _calc_pair(
        lambda m: m.MockKafkaSource([_records(5)], startup_mode="offsets",
                                    start_offsets={0: 4}))
    assert got == want and got["id"] == [4]


def test_streaming_bad_records_become_nulls():
    recs = [b"not json", json.dumps({"id": 7, "v": 1.0, "s": "x"}).encode()]
    (got, _), (want, _) = _calc_pair(lambda m: m.MockKafkaSource([recs]))
    assert got == want and got["id"] == [7]  # bad record -> null id -> filtered


def test_mock_source_partition_assignment():
    """The port's mock takes a task's split (``partitions``): it polls and
    reports only those partitions; unassigned, it is the reference's."""
    parts = [_records(5), _records(3, start=5)]
    src = S.MockKafkaSource(parts, partitions=[1])
    got = []
    while (vals := src.poll(2)) is not None:
        got += vals
    assert got == parts[1] and src.offsets() == {1: 3}
    a, b = S.MockKafkaSource(parts), JS.MockKafkaSource(parts)
    while (x := a.poll(3)) is not None:
        assert x == b.poll(3)
    assert b.poll(3) is None and a.offsets() == b.offsets()


def test_bloom_filter_no_false_negatives():
    import jax.numpy as jnp
    import torch

    from auron_tpu.ops.bloom import SparkBloomFilter as JBloom
    from auron_tpu_torch.ops.bloom import SparkBloomFilter

    rng = np.random.default_rng(23)
    items = rng.integers(-(2**62), 2**62, 5000)
    others = rng.integers(-(2**62), 2**62, 5000)
    bf = SparkBloomFilter.create(5000, fpp=0.03, device="cpu")
    bf.put_long(torch.from_numpy(items))
    jbf = JBloom.create(5000, fpp=0.03)
    jbf.put_long(jnp.asarray(items))
    assert bool(bf.might_contain_long(torch.from_numpy(items)).all())
    hits = bf.might_contain_long(torch.from_numpy(others)).numpy()
    assert float(hits.mean()) < 0.1
    assert np.array_equal(hits, np.asarray(jbf.might_contain_long(jnp.asarray(others))))
    # serde roundtrip, and the bytes are the reference's
    assert bf.serialize() == jbf.serialize()
    bf2 = SparkBloomFilter.deserialize(jbf.serialize(), device="cpu")
    assert bool(bf2.might_contain_long(torch.from_numpy(items)).all())


def test_bloom_might_contain_expr():
    import jax.numpy as jnp
    import torch

    from auron_tpu.columnar import Batch as JBatch
    from auron_tpu.exec.basic import MemoryScanExec as JScan
    from auron_tpu.exec.basic import ProjectExec as JProject
    from auron_tpu.ops.bloom import SparkBloomFilter as JBloom
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec, ProjectExec
    from auron_tpu_torch.ops.bloom import SparkBloomFilter

    bf = SparkBloomFilter.create(10, device="cpu")
    bf.put_long(torch.tensor([5, 7, 9], dtype=torch.int64))
    jbf = JBloom.create(10)
    jbf.put_long(jnp.asarray([5, 7, 9], dtype=jnp.int64))
    payload = bf.serialize()
    assert payload == jbf.serialize()
    schema = T.Schema.of(T.Field("x", T.INT64))
    b = Batch.from_numpy([np.array([5, 6, 7, 8], np.int64)], schema, device="cpu")
    p = ProjectExec(MemoryScanExec([[b]], schema),
                    [IR.ScalarFunc("bloom_filter_might_contain",
                                   (IR.lit(payload, T.BINARY), IR.col(0)))], ["hit"])
    got = [r for bb in p.execute(0, ExecutionContext(device="cpu"))
           for r in bb.to_pydict()["hit"]]
    jb = JBatch.from_pydict({"x": [5, 6, 7, 8]}, schema=JT.Schema.of(JT.Field("x", JT.INT64)))
    jp = JProject(JScan.single([jb]),
                  [JIR.ScalarFunc("bloom_filter_might_contain",
                                  (JIR.lit(payload, JT.BINARY), JIR.col(0)))], ["hit"])
    assert got == jp.collect_pydict()["hit"]
    assert got[0] is True and got[2] is True  # no false negatives


def test_broadcast_and_aqe(tmp_path):
    """An Arrow IPC round trip of a batch, then AQE statistics over real
    shuffle index files: the port's per-partition sizes and coalesced
    groups against the reference's over its own files of the same rows."""
    from auron_tpu.columnar import Batch as JBatch
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu.exec.basic import MemoryScanExec as JScan
    from auron_tpu.exec.shuffle import HashPartitioning as JHash
    from auron_tpu.exec.shuffle import ShuffleWriterExec as JWriter
    from auron_tpu.parallel.broadcast import map_output_stats
    from auron_tpu.parallel.broadcast import plan_coalesced_partitions as jplan
    from auron_tpu_torch.columnar import arrow_ipc
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.parallel.broadcast import map_output_sizes, plan_coalesced_partitions

    x = T.Schema.of(T.Field("x", T.INT64))
    b = Batch.from_numpy([np.array([1, 2, 3], np.int64)], x, device="cpu")
    back = arrow_ipc.read_stream(arrow_ipc.write_stream([b.to_host_arrow()]))
    assert Batch.from_host_arrow(back[0], device="cpu").to_pydict() == {"x": [1, 2, 3]}

    k = T.Schema.of(T.Field("k", T.INT64))
    idx, jidx = [], []
    for m in range(2):
        scan = MemoryScanExec([[Batch.from_numpy([np.arange(100, dtype=np.int64)], k,
                                                 device="cpu")]], k)
        d, i = str(tmp_path / f"m{m}.data"), str(tmp_path / f"m{m}.index")
        list(ShuffleWriterExec(scan, HashPartitioning([IR.col(0)], 8), d, i)
             .execute(0, ExecutionContext(device="cpu")))
        idx.append(i)
        jscan = JScan.single([JBatch.from_pydict({"k": list(range(100))})])
        d, i = str(tmp_path / f"j{m}.data"), str(tmp_path / f"j{m}.index")
        list(JWriter(jscan, JHash([JIR.col(0)], 8), d, i).execute(0, JCtx()))
        jidx.append(i)
    stats = map_output_sizes(idx, 8).sum(axis=0)
    jstats = map_output_stats(jidx)
    assert len(stats) == len(jstats) == 8 and stats.sum() > 0
    assert np.array_equal(stats > 0, jstats > 0)  # the same partitions hold rows
    groups = plan_coalesced_partitions(stats, target_bytes=int(stats.sum() // 3))
    assert sum(len(g) for g in groups) == 8 and len(groups) <= 4
    assert plan_coalesced_partitions(jstats, int(jstats.sum() // 3)) == \
        jplan(jstats, target_bytes=int(jstats.sum() // 3))


# ---------------------------------------------------------------------------
# protobuf serde, error policies, kafka_scan in the plan IR
# ---------------------------------------------------------------------------


def _pb_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_record(id_v=None, price=None, name=None) -> bytes:
    """Encode {1: int64 id, 2: double price, 3: string name}."""
    out = bytearray()
    if id_v is not None:
        out += _pb_varint((1 << 3) | 0) + _pb_varint(id_v)
    if price is not None:
        out += _pb_varint((2 << 3) | 1) + struct.pack("<d", price)
    if name is not None:
        nb = name.encode()
        out += _pb_varint((3 << 3) | 2) + _pb_varint(len(nb)) + nb
    return bytes(out)


def test_protobuf_row_deserializer():
    rows = [_pb_record(1, 9.5, "a"), _pb_record(-2, None, "b"), _pb_record(3, 0.25, None)]
    de, jde = S.ProtobufRowDeserializer(PB[0]), JS.ProtobufRowDeserializer(PB[1])
    got = de.deserialize(rows)
    assert got.equals(jde.deserialize(rows))
    got = got.to_pydict()
    assert got["id"] == [1, -2, 3]
    assert got["price"] == [9.5, None, 0.25]  # missing field -> NULL
    assert got["name"] == ["a", "b", None]
    assert de.errors == jde.errors == 0


@pytest.mark.parametrize("policy", ["skip", "null", "fail"])
def test_deserializer_error_policies(policy):
    bad = b"\xff\xff\xff"  # truncated varint
    rows = [_pb_record(1, 1.0, "x"), bad, _pb_record(2, 2.0, "y")]
    de = S.ProtobufRowDeserializer(PB[0], on_error=policy)
    jde = JS.ProtobufRowDeserializer(PB[1], on_error=policy)
    if policy == "fail":
        with pytest.raises(S.DeserializeError):
            de.deserialize(rows)
        with pytest.raises(JS.DeserializeError):
            jde.deserialize(rows)
        return
    got = de.deserialize(rows)
    assert got.equals(jde.deserialize(rows))
    assert got.to_pydict()["id"] == ([1, 2] if policy == "skip" else [1, None, 2])
    assert de.errors == jde.errors == 1


def test_planned_kafka_scan_calc_query():
    """kafka_scan is a plan node: a streaming Calc query built from proto
    bytes runs through the normal task runtime, in both packages."""
    from auron_tpu.bridge import api as japi
    from auron_tpu.plan import builders as JB
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.plan import builders as B

    records = [_pb_record(i, i * 2.0, f"n{i}") for i in range(10)]
    out = []
    for mod, builders, bridge, ir, schema, kw in (
            (S, B, api, IR, PB[0], {"device": "cpu"}), (JS, JB, japi, JIR, PB[1], {})):
        bridge.put_resource("kafka_src", lambda topic, mode, offsets, mod=mod: (
            mod.MockKafkaSource([records], startup_mode=mode, start_offsets=offsets)))
        try:
            scan = builders.kafka_scan(schema, "orders", "kafka_src", data_format="protobuf",
                                       on_error="skip")
            calc = builders.project(
                builders.filter_(scan, [ir.BinaryOp("gteq", ir.col(0), ir.lit(5))]),
                [(ir.col(0), "id"), (ir.BinaryOp("mul", ir.col(1), ir.lit(10.0)), "p10")])
            h = bridge.call_native(builders.task(calc).SerializeToString(), **kw)
            ids, p10 = [], []
            while (rb := bridge.next_batch(h)) is not None:
                d = rb.to_pydict()
                ids += d["id"]
                p10 += d["p10"]
            metrics = bridge.finalize_native(h)
            out.append((ids, p10, metrics["values"].get("kafka_offset_p0")))
            # the checkpoint offsets are task-scoped
            assert bridge.get_resource("kafka_src.offsets") is None
        finally:
            bridge.remove_resource("kafka_src")
    assert out[0][:2] == out[1][:2] == (list(range(5, 10)), [i * 20.0 for i in range(5, 10)])


def test_planned_kafka_scan_offset_resume_and_error_metric():
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu_torch.exec.base import ExecutionContext

    records = [_pb_record(i, float(i), "x") for i in range(6)] + [b"\xff"]
    got = []
    for mod, schema, ctx_of in ((S, PB[0], lambda r: ExecutionContext(device="cpu", resources=r)),
                                (JS, PB[1], lambda r: JCtx(resources=r))):
        src = mod.MockKafkaSource([records], startup_mode="offsets", start_offsets={0: 4})
        op = mod.KafkaScanExec(schema, "t", "src", startup_mode="offsets",
                               start_offsets={0: 4}, data_format="protobuf", on_error="skip")
        ctx = ctx_of({"src": src})
        ids = [i for b in op.execute(0, ctx) for i in b.to_pydict()["id"]]
        m = ctx.metrics.snapshot()["values"]
        got.append((ids, m["deserialize_errors"], ctx.resources["src.offsets"],
                    m["kafka_offset_p0"]))
    # resumed from offset 4; the bad record skipped and counted
    assert got[0] == got[1] == ([4, 5], 1, {0: 7}, 7)


def test_zigzag_sint_columns_via_plan():
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu.plan.planner import plan_from_proto as jplan
    from auron_tpu_torch import proto as pb
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.plan import builders as B
    from auron_tpu_torch.plan.planner import plan_from_proto

    def zz(v):  # zigzag encode
        return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1

    recs = [_pb_varint((1 << 3) | 0) + _pb_varint(zz(v)) for v in (-1, -2, 3)]
    wire = B.kafka_scan(T.Schema.of(T.Field("d", T.INT64)), "t", "zz_src",
                        data_format="protobuf", zigzag_cols=[0]).SerializeToString()
    op = plan_from_proto(pb.PhysicalPlanNode.FromString(wire))
    got = [d for b in op.execute(0, ExecutionContext(
        device="cpu", resources={"zz_src": S.MockKafkaSource([recs])}))
        for d in b.to_pydict()["d"]]
    from auron_tpu.proto import plan_pb2

    jop = jplan(plan_pb2.PhysicalPlanNode.FromString(wire))
    want = [d for b in jop.execute(0, JCtx(resources={"zz_src": JS.MockKafkaSource([recs])}))
            for d in b.to_pydict()["d"]]
    assert got == want == [-1, -2, 3]


def test_offsets_surfaced_on_fail_abort():
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu_torch.exec.base import ExecutionContext

    recs = [_pb_record(1, 1.0, "a"), b"\xff", _pb_record(2, 2.0, "b")]
    for mod, schema, ctx in ((S, PB[0], ExecutionContext(device="cpu")), (JS, PB[1], JCtx())):
        ctx.resources["src"] = mod.MockKafkaSource([recs])
        op = mod.KafkaScanExec(schema, "t", "src", data_format="protobuf", on_error="fail")
        with pytest.raises(mod.DeserializeError):
            list(op.execute(0, ctx))
        # the abort path still surfaces checkpoint offsets and the error count
        assert ctx.resources["src.offsets"] == {0: 3}
        assert ctx.metrics.snapshot()["values"]["deserialize_errors"] == 1


def test_unknown_format_fails_fast():
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu_torch.exec.base import ExecutionContext

    for mod, schema, ctx in ((S, PB[0], ExecutionContext(device="cpu")), (JS, PB[1], JCtx())):
        ctx.resources["src"] = mod.MockKafkaSource([[b"{}"]])
        op = mod.KafkaScanExec(schema, "t", "src", data_format="avro")
        with pytest.raises(ValueError, match="unsupported streaming format"):
            list(op.execute(0, ctx))
        assert "src.offsets" not in ctx.resources  # the source was never polled


# ---------------------------------------------------------------------------
# the planned keyed exchange, against the JAX package and pandas
# ---------------------------------------------------------------------------


def _reference_exchange(parts, n_reduce, work):
    """The same two stages through the JAX package: the plans from its
    builders, the tasks from bytes through its bridge."""
    from auron_tpu.bridge import api as japi
    from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider
    from auron_tpu.ops.sortkeys import SortSpec as JSpec
    from auron_tpu.plan import builders as JB
    from auron_tpu.plan.planner import plan_from_proto as jplan
    from auron_tpu_torch.models import kafka_exchange as KX

    schema = JT.Schema.of(*(JT.Field(f.name, getattr(JT, f.dtype.kind.name)) for f in KX.SCHEMA))

    def partial(scan):
        f = JB.filter_(scan, [JIR.BinaryOp("gt", JIR.col(2), JIR.lit(0.0))])
        proj = JB.project(f, [(JIR.col(0), "user"),
                              (JIR.BinaryOp("mul", JIR.col(2), JIR.Cast(JIR.col(3), JT.FLOAT64)),
                               "amount")])
        return JB.hash_agg(proj, [(JIR.col(0), "user")],
                           [("sum", JIR.col(1), "total"), ("count", JIR.col(1), "n")], "partial")

    def drain(task, resources):
        h = japi.call_native(task.SerializeToString(), resources)
        out = []
        while (rb := japi.next_batch(h)) is not None:
            out.append(rb)
        japi.finalize_native(h)
        return out

    pairs = []
    for p in range(len(parts)):
        d, i = str(work / f"j{p}.data"), str(work / f"j{p}.index")
        pairs.append((d, i))
        scan = JB.kafka_scan(schema, KX.TOPIC, KX.SOURCE, data_format="json",
                             max_batch_records=KX.MAX_BATCH_RECORDS)
        w = JB.shuffle_writer(partial(scan), JB.hash_partitioning([JIR.col(0)], n_reduce), d, i)
        drain(JB.task(w, 1, p), {KX.SOURCE: KX.split_source(parts, p)})
    inter = jplan(partial(JB.kafka_scan(schema, KX.TOPIC, KX.SOURCE))).schema
    outs = []
    for r in range(n_reduce):
        agg = JB.hash_agg(JB.ipc_reader(inter, "j_ex"), [(JIR.col(0), "user")],
                          [("sum", JIR.col(1), "total"), ("count", JIR.col(2), "n")], "final")
        srt = JB.sort(agg, [(JIR.col(1), JSpec(asc=False)), (JIR.col(0), JSpec())])
        rows = {"user": [], "total": [], "n": []}
        for rb in drain(JB.task(srt, 2, r), {"j_ex": MultiMapBlockProvider(pairs)}):
            for k, v in rb.to_pydict().items():
                rows[k] += v
        outs.append(rows)
    return outs


def test_planned_keyed_exchange_equals_the_reference_and_pandas(tmp_path):
    from auron_tpu_torch.models import kafka_exchange as KX

    parts = KX.corpus(3000, users=64)
    st: dict = {}
    outs = KX.run(parts, n_reduce=4, device="cpu", stats=st)
    assert KX.mismatch(outs, KX.oracle(parts)) is None
    want = _reference_exchange(parts, 4, tmp_path)
    for got, ref in zip(outs, want):
        assert got["user"].tolist() == ref["user"] and got["n"].tolist() == ref["n"]
        assert got["total"].tolist() == ref["total"]  # quarters: every sum is exact
    assert st["offsets"] == {0: 1500, 1: 1500}
    assert st["stream_batches"] == KX.micro_batches(parts) == 2
    assert sum(st["rows"]) == 64


def test_streaming_modules_import_without_jax_or_pyarrow():
    """A fresh interpreter imports the port's streaming modules and loads
    neither jax, nor the JAX package, nor pyarrow."""
    code = (
        "import sys\n"
        "import auron_tpu_torch.stream, auron_tpu_torch.serve.streams\n"
        "import auron_tpu_torch.exec.kafka_wire, auron_tpu_torch.exec.streaming\n"
        "import auron_tpu_torch.models.streamgate, auron_tpu_torch.models.kafka_exchange\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'auron_tpu', 'pyarrow'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_two_map_tasks_in_a_fresh_process_do_not_crash_on_pyarrow():
    """In a fresh interpreter whose first pyarrow import happens on a task
    pump (the shuffle writer's codec probe), the next task's pump still
    allocates from pyarrow: ``utils/arrowlib.pyarrow()`` imports it on a
    thread that never exits (with pyarrow 25 the pool of an exited
    importing thread segfaults the next allocation)."""
    code = (
        "import sys\n"
        "from auron_tpu_torch.models import kafka_exchange as KX\n"
        "assert 'pyarrow' not in sys.modules\n"
        "parts = KX.corpus(400, users=16)\n"
        "outs = KX.run(parts, n_reduce=2, device='cpu')\n"
        "assert sum(len(o['user']) for o in outs) == 16\n"
        "print('survived')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "survived" in r.stdout, (r.returncode, r.stderr[-2000:])
