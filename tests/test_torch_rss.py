"""Slice 18: the remote shuffle service of the port (``exec/shuffle/rss.py``,
``rss_net.py``, ``RssShuffleWriterExec``) on the CPU.

- the reference's in-process RSS cases (``tests/test_shuffle.py``): the push
  writer's blocks land in their hash partitions; the service end to end
  equals the rows (and replica 1 the same); uncommitted pushes stay
  invisible and a retry's attempt commits one copy; a speculative attempt
  cannot change committed output; the fetch crosses as raw payload bytes
  and ``push_payloads`` relays a file shuffle's blocks byte for byte;
- the reference's eleven TCP cases (``tests/test_rss_net.py``): the
  shuffle over the wire (replica 1 too), attempt isolation,
  first-commit-wins, abort, a 3 MiB block, writers sharing a client from
  threads, a server error relayed, paging past the reply budget, a dropped
  connection and a partial frame retried, a dropped push raising, and a
  stalled server timing out; each test has a time limit of its own, and the
  one real timeout a test waits on is half a second;
- blocks written by the JAX package's RSS writer read in the port and the
  reverse, and q93 through the port's RSS equals the JAX file shuffle's
  answer."""

import functools
import struct
import threading

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.shuffle import rss as jrss
from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
from auron_tpu.exec.shuffle.writer import RssShuffleWriterExec as JRssWriter
from auron_tpu.exprs.ir import col as jcol

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.shuffle import format as pf
from auron_tpu_torch.exec.shuffle import rss_net as RN
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
from auron_tpu_torch.exec.shuffle.reader import (
    IpcReaderExec, LocalFileBlockProvider, MultiMapBlockProvider,
)
from auron_tpu_torch.exec.shuffle.rss import (
    LocalRssService, RssBlockProvider, RssPartitionWriterClient, push_payloads,
)
from auron_tpu_torch.exec.shuffle.writer import RssShuffleWriterExec, ShuffleWriterExec
from auron_tpu_torch.exprs.ir import col
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.plan import builders as B
from torch_carry import carry, jax_batch, port_schema, rows

KV = T.Schema((T.Field("k", T.INT64, True), T.Field("v", T.INT64, True)))


def limited(seconds: float):
    """Fail the test when its body runs past ``seconds`` (the body runs on
    a daemon thread, so a hang cannot stall the test run)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised on the test thread
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "err" in box:
                raise box["err"]
        return run
    return wrap


def _kv(n=3000, seed=2, n_parts=1):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n).astype(np.int64)
    v = rng.integers(-10, 10, n).astype(np.int64)
    per = -(-n // n_parts)
    parts = [[Batch.from_numpy([k[p * per:(p + 1) * per], v[p * per:(p + 1) * per]], KV,
                               device="cpu")] for p in range(n_parts)]
    return parts, sorted(zip(k.tolist(), v.tolist()))


def _reduce(provider, n_red, schema=KV):
    out = []
    for p in range(n_red):
        ctx = PCtx(device="cpu", resources={"blocks": provider})
        out += rows(list(IpcReaderExec(schema, "blocks").execute(p, ctx)))
    return sorted(out)


# ---------------------------------------------------------------------------
# the in-process service (tests/test_shuffle.py)
# ---------------------------------------------------------------------------


def test_rss_push_writer():
    """Blocks pushed per partition to a writer object: every row lands in
    its hash partition, the writer is flushed once."""
    from auron_tpu_torch.ops.hash_dispatch import hash_batch
    from auron_tpu_torch.ops.hashing import pmod

    parts, want = _kv(200, seed=5)
    pushed: dict = {}
    flushed = []

    class FakeRssClient:
        def write(self, pid, blk):
            pushed.setdefault(pid, []).append(blk)

        def flush(self):
            flushed.append(True)

    w = RssShuffleWriterExec(PScan(parts, KV), HashPartitioning([col(0)], 5), "rss")
    assert list(w.execute(0, PCtx(device="cpu", resources={"rss": FakeRssClient()}))) == []
    assert flushed == [True]
    got = []
    for pid, blocks in pushed.items():
        for blk in blocks:
            for payload in pf.iter_block_payloads(blk):
                n, ((k, _), (v, _)) = pf.decode_block(payload, KV)
                kb = Batch.from_numpy([k, v], KV, device="cpu")
                pids = pmod(hash_batch(kb, [0], "murmur3", seed=42), 5)[:n]
                assert (pids == pid).all()
                got += list(zip(k.tolist(), v.tolist()))
    assert sorted(got) == want


def test_rss_end_to_end_matches_file_shuffle(tmp_path):
    """Three map tasks from plan protos push through the service; the
    reduce tasks read it as the file shuffle's pairs read; replica 1 holds
    the same rows."""
    from auron_tpu_torch.bridge import api
    from torch_carry import run_tree

    parts, want = _kv(3000, seed=3, n_parts=3)
    svc = LocalRssService(num_replicas=2)
    part = B.hash_partitioning([col(0)], 4)
    pairs = []
    for m in range(3):
        w = B.rss_shuffle_writer(B.memory_scan(KV, "src"), part, "w")
        task = B.task(w, partition_id=m).SerializeToString()
        with api.native_task(task, {"src": parts, "w": RssPartitionWriterClient(svc, "s1", m)},
                             "cpu") as h:
            assert api.next_batch(h) is None
        d, i = str(tmp_path / f"m{m}.data"), str(tmp_path / f"m{m}.index")
        run_tree(ShuffleWriterExec(PScan(parts, KV), HashPartitioning([col(0)], 4), d, i),
                 {}, 0, m, None, "cpu")
        pairs.append((d, i))
    assert _reduce(RssBlockProvider(svc, "s1"), 4) == want
    assert _reduce(RssBlockProvider(svc, "s1", replica=1), 4) == want
    assert _reduce(MultiMapBlockProvider(pairs), 4) == want


def _block(x):
    return pf.encode_block(T.Schema((T.Field("x", T.INT64),)),
                           [(np.asarray(x, np.int64), None)])


def test_rss_commit_and_retry_semantics():
    svc = LocalRssService()
    blk = _block([1, 2, 3])
    w = RssPartitionWriterClient(svc, "s", map_id=0)
    w.write(0, blk)
    assert svc.fetch("s", 0) == []  # uncommitted: invisible to readers
    w2 = RssPartitionWriterClient(svc, "s", map_id=0)  # the task's retry
    w2.write(0, blk)
    w2.flush()
    assert len(svc.fetch("s", 0)) == 1  # exactly one committed copy


def test_rss_speculative_attempt_cannot_destroy_committed():
    svc = LocalRssService()
    blk = _block([1])
    w = RssPartitionWriterClient(svc, "s2", map_id=0)
    w.write(0, blk)
    w.flush()
    spec = RssPartitionWriterClient(svc, "s2", map_id=0)
    assert len(svc.fetch("s2", 0)) == 1  # a new attempt wipes nothing
    spec.write(0, blk)
    spec.write(0, blk)
    spec.flush()
    assert svc.fetch("s2", 0) == [blk]  # first wins


def test_rss_fetch_rides_iter_payloads_raw_bytes(tmp_path):
    """A file shuffle's blocks relayed into the service (``push_payloads``)
    arrive byte for byte and read to the same rows."""
    parts, want = _kv(2000, seed=9)
    d, i = str(tmp_path / "m.data"), str(tmp_path / "m.index")
    from torch_carry import run_tree

    run_tree(ShuffleWriterExec(PScan(parts, KV), HashPartitioning([col(0)], 3), d, i),
             {}, 0, 0, None, "cpu")
    svc = LocalRssService()
    src = LocalFileBlockProvider(d, i)
    n = push_payloads(src, RssPartitionWriterClient(svc, "relay", 0), 3)
    assert n == sum(len(list(src.iter_payloads(p))) for p in range(3))
    prov = RssBlockProvider(svc, "relay")
    for p in range(3):
        assert list(prov.iter_payloads(p)) == list(src.iter_payloads(p))
    assert _reduce(prov, 3) == want


def test_failed_map_attempt_aborts():
    """A map stream that fails aborts its attempt: the service drops what it
    pushed, and nothing commits."""
    parts, _ = _kv(500)

    class Boom(PScan):
        def _execute(self, partition, ctx):
            yield from super()._execute(partition, ctx)
            raise RuntimeError("map task lost")

    svc = LocalRssService()
    w = RssPartitionWriterClient(svc, "ab", 0)
    op = RssShuffleWriterExec(Boom(parts, KV), HashPartitioning([col(0)], 2), "w")
    with pytest.raises(RuntimeError, match="lost"):
        list(op.execute(0, PCtx(device="cpu", resources={"w": w})))
    assert svc._staging == {} and svc.fetch("ab", 0) == [] and svc.fetch("ab", 1) == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_blocks_cross_the_service_between_packages(writer):
    """The JAX package's RSS writer pushes to the port's service and the
    port's to the JAX one's; each package's reader reads the other's rows."""
    rng = np.random.default_rng(4)
    jb = jax_batch({"k": rng.integers(0, 99, 2000).astype(np.int64),
                    "x": rng.choice(np.sqrt(np.arange(2, 18)), 2000)})
    want = sorted(rows([jb]))
    if writer == "jax":
        svc = LocalRssService()
        w = JRssWriter(JScan([[jb]], jb.schema), JHash([jcol(0)], 3), "w")
        list(w.execute(0, JCtx(resources={"w": RssPartitionWriterClient(svc, "x", 0)})))
        got = _reduce(RssBlockProvider(svc, "x"), 3, port_schema(jb.schema))
    else:
        svc = jrss.LocalRssService()
        pb = carry(jb)
        w = RssShuffleWriterExec(PScan([[pb]], pb.schema), HashPartitioning([col(0)], 3), "w")
        list(w.execute(0, PCtx(device="cpu",
                               resources={"w": jrss.RssPartitionWriterClient(svc, "x", 0)})))
        got = sorted(r for p in range(3) for r in rows(list(JReader(jb.schema, "b").execute(
            p, JCtx(resources={"b": jrss.RssBlockProvider(svc, "x")})))))
    assert got == want


def _mixed_batch(n=1500, seed=6):
    """The reference's batch of int, float, string (dictionary), bool and
    nullable columns: the plane encoders' kinds, ENC_DICT and validity."""
    rng = np.random.default_rng(seed)
    words = np.array(["a", "bb", "ccc", "dddd", "ee"], dtype=object)
    return jax_batch(
        {"k": rng.integers(0, 40, n).astype(np.int64),
         "x": rng.choice(np.sqrt(np.arange(2, 30)), n),
         "s": words[rng.integers(0, len(words), n)],
         "b": rng.random(n) < 0.3,
         "m": rng.integers(-5, 5, n).astype(np.int32)},
        valid={"s": rng.random(n) < 0.9, "m": rng.random(n) < 0.4})


@pytest.mark.parametrize("encoding", ["on", "off"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rss_provider_batches_equal_the_reference(writer, encoding):
    """One pushed shuffle (v2 blocks, or v1 Arrow IPC blocks with the
    encoding off) read through ``RssBlockProvider.__call__``: every
    partition's RecordBatches equal the reference provider's over the same
    blocks, schema and values, and ``decode_blocks`` of each block equals
    the reference's ``decode_blocks``."""
    from auron_tpu.exec.shuffle import format as jf
    from auron_tpu.utils.config import Configuration as JConf

    from auron_tpu_torch.utils.config import Configuration as PConf

    jb = _mixed_batch()
    svc = LocalRssService()
    key = "exec.shuffle.encoding"
    if writer == "jax":
        w = JRssWriter(JScan([[jb]], jb.schema), JHash([jcol(0)], 3), "w")
        list(w.execute(0, JCtx(conf=JConf().set(key, encoding),
                               resources={"w": RssPartitionWriterClient(svc, "mx", 0)})))
    else:
        pb = carry(jb)
        w = RssShuffleWriterExec(PScan([[pb]], pb.schema), HashPartitioning([col(0)], 3), "w")
        list(w.execute(0, PCtx(device="cpu", conf=PConf().set(key, encoding),
                               resources={"w": RssPartitionWriterClient(svc, "mx", 0)})))
    port, ref = RssBlockProvider(svc, "mx"), jrss.RssBlockProvider(svc, "mx")
    n_rows = 0
    for p in range(3):
        got, want = list(port(p)), list(ref(p))
        assert got and len(got) == len(want)
        for g, r in zip(got, want):
            assert g.schema.equals(r.schema, check_metadata=True), (g.schema, r.schema)
            assert g.equals(r)
            n_rows += g.num_rows
        for block in svc.fetch("mx", p):
            assert [b.to_pydict() for b in pf.decode_blocks(block)] == \
                [b.to_pydict() for b in jf.decode_blocks(block)]
            assert all(pf.is_v2_payload(x) == (encoding == "on")
                       for x in pf.iter_block_payloads(block))
    assert n_rows == 1500


def test_decode_blocks_refuses_a_corrupt_v2_block():
    """A v2 block whose column count disagrees with its schema section, or
    whose column payload is cut short, raises ValueError, as the
    reference's does."""
    from auron_tpu.exec.shuffle import format as jf

    block = _block([1, 2, 3])
    assert [b.to_pydict() for b in pf.decode_blocks(block)] == [{"x": [1, 2, 3]}]
    two_cols = block[:14] + struct.pack("<H", 2) + block[16:]
    cut = struct.pack("<Q", len(block) - 9) + block[8:-1]
    for bad in (two_cols, cut):
        with pytest.raises(ValueError, match="corrupt|mismatch|truncated"):
            list(pf.decode_blocks(bad))
        with pytest.raises(ValueError):
            list(jf.decode_blocks(bad))


def test_q93_through_the_rss_equals_the_reference_file_shuffle():
    from auron_tpu.models import tpcds as jt

    d = pt.generate(0.02, 42)
    st = {}
    got = pt.run_q93_class(d, device="cpu", transport="rss", stats=st)
    want = jt.run_q93_class(jt.generate(0.02, 42), n_map=4, n_reduce=4)
    np.testing.assert_array_equal(got["rows"], np.asarray(want["rows"], np.int64))
    np.testing.assert_array_equal(got["matched"], np.asarray(want["matched"], np.int64))
    np.testing.assert_allclose(got["s"], np.asarray(want["s"], np.float64), rtol=1e-9)
    assert st["timers"]["RssShuffleWriterExec.push_time"] > 0
    assert st["counters"]["IpcReaderExec.shuffle_bytes_read"] > 0


# ---------------------------------------------------------------------------
# the TCP service (tests/test_rss_net.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def server():
    srv = RN.RssNetServer(LocalRssService(num_replicas=2))
    yield srv
    srv.close()


@limited(30)
def test_shuffle_rides_the_wire(server):
    parts, want = _kv(3000, seed=2, n_parts=2)
    client = RN.RssNetClient(server.addr)
    w = RssShuffleWriterExec(PScan(parts, KV), HashPartitioning([col(0)], 4), "rss")
    for map_id in range(2):
        ctx = PCtx(device="cpu", partition_id=map_id,
                   resources={"rss": RN.RemotePartitionWriter(client, "s1", map_id)})
        assert list(w.execute(map_id, ctx)) == []
    assert _reduce(RN.RemoteBlockProvider(client, "s1"), 4) == want
    assert _reduce(RN.RemoteBlockProvider(client, "s1", replica=1), 4) == want
    client.close()


@limited(10)
def test_speculative_attempt_isolation_over_wire(server):
    client = RN.RssNetClient(server.addr)
    w1 = RN.RemotePartitionWriter(client, "spec", 0)
    w2 = RN.RemotePartitionWriter(client, "spec", 0)  # a speculative duplicate
    w1.write(0, b"from-w1")
    w2.write(0, b"from-w2")
    w2.flush()  # commits first: wins
    w1.flush()  # a late commit is dropped
    assert client.fetch("spec", 0) == [b"from-w2"]
    client.close()


@limited(10)
def test_abort_discards_staged(server):
    client = RN.RssNetClient(server.addr)
    w = RN.RemotePartitionWriter(client, "ab", 0)
    w.write(0, b"staged")
    w.abort()
    w.flush()  # a commit after the abort finds nothing
    assert client.fetch("ab", 0) == []
    client.close()


@limited(20)
def test_large_block_framing(server):
    client = RN.RssNetClient(server.addr)
    big = bytes(np.random.default_rng(0).integers(0, 256, 3 << 20, dtype=np.uint8))
    w = RN.RemotePartitionWriter(client, "big", 0)
    w.write(1, big)
    w.flush()
    assert client.fetch("big", 1) == [big]
    client.close()


@limited(30)
def test_concurrent_writers_shared_client(server):
    client = RN.RssNetClient(server.addr)
    errs = []

    def work(map_id):
        try:
            w = RN.RemotePartitionWriter(client, "conc", map_id)
            for p in range(8):
                w.write(p, f"m{map_id}p{p}".encode())
            w.flush()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    assert not errs
    for p in range(8):
        assert sorted(client.fetch("conc", p)) == sorted(f"m{i}p{p}".encode() for i in range(6))
    client.close()


@limited(10)
def test_server_error_relayed(server, monkeypatch):
    client = RN.RssNetClient(server.addr)

    def boom(*a, **k):
        raise RuntimeError("disk full on shuffle node")

    monkeypatch.setattr(server.service, "fetch", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        client.fetch("x", 0)
    client.close()


@limited(10)
def test_fetch_pages_through_reply_budget(server, monkeypatch):
    monkeypatch.setattr(RN, "_MAX_REPLY", 64)  # a tiny budget: many pages
    client = RN.RssNetClient(server.addr)
    blocks = [f"block-{i:03d}".encode() * 4 for i in range(23)]
    w = RN.RemotePartitionWriter(client, "page", 0)
    for b in blocks:
        w.write(2, b)
    w.flush()
    assert client.fetch("page", 2) == blocks
    client.close()


def _faulty(op_code, action):
    faults = {"n": 0}

    def hook(op):
        if op == op_code and faults["n"] == 0:
            faults["n"] += 1
            return action
        return None

    return RN.RssNetServer(fault_hook=hook), faults


@limited(10)
def test_fetch_survives_connection_drop():
    srv, faults = _faulty(RN.OP_FETCH, "drop_before")
    try:
        cl = RN.RssNetClient(srv.addr)
        att = cl.new_attempt("s1", 0)
        cl.push("s1", 0, att, 0, b"hello")
        cl.commit("s1", 0, att)
        assert cl.fetch("s1", 0) == [b"hello"]
        assert faults["n"] == 1  # the fault fired, the retry answered
        cl.close()
    finally:
        srv.close()


@limited(10)
def test_fetch_survives_partial_frame():
    srv, faults = _faulty(RN.OP_FETCH, "partial_reply")
    try:
        cl = RN.RssNetClient(srv.addr)
        att = cl.new_attempt("s2", 0)
        cl.push("s2", 0, att, 1, b"blockA")
        cl.commit("s2", 0, att)
        assert cl.fetch("s2", 1) == [b"blockA"]
        assert faults["n"] == 1
        cl.close()
    finally:
        srv.close()


@limited(10)
def test_push_drop_is_loud_and_reattempt_is_clean():
    srv, _ = _faulty(RN.OP_PUSH, "drop_before")
    try:
        cl = RN.RssNetClient(srv.addr)
        a1 = cl.new_attempt("s3", 0)
        with pytest.raises((ConnectionError, OSError)):
            cl.push("s3", 0, a1, 0, b"broken")
        a2 = cl.new_attempt("s3", 0)  # a new attempt over the reconnected client
        cl.push("s3", 0, a2, 0, b"good")
        cl.commit("s3", 0, a2)
        assert cl.fetch("s3", 0) == [b"good"]
        cl.close()
    finally:
        srv.close()


@limited(10)
def test_slow_server_times_out_cleanly():
    """A stalled reply surfaces as a timeout error, not a hang."""
    srv = RN.RssNetServer(fault_hook=lambda op: "delay:2" if op == RN.OP_FETCH else None)
    try:
        cl = RN.RssNetClient(srv.addr, timeout_s=0.5)
        att = cl.new_attempt("s4", 0)
        cl.push("s4", 0, att, 0, b"x")
        cl.commit("s4", 0, att)
        with pytest.raises((TimeoutError, OSError)):
            cl.fetch("s4", 0)
        cl.close()
    finally:
        srv.close()


def test_wire_frames_are_the_references():
    """The client's request frames are the JAX client's, byte for byte."""
    from auron_tpu.exec.shuffle import rss_net as jrn

    assert RN._enc_str("shuf") == jrn._enc_str("shuf")
    assert (RN.OP_NEW, RN.OP_PUSH, RN.OP_COMMIT, RN.OP_ABORT, RN.OP_FETCH) == \
        (jrn.OP_NEW, jrn.OP_PUSH, jrn.OP_COMMIT, jrn.OP_ABORT, jrn.OP_FETCH)
    assert (RN._MAX_FRAME, RN._MAX_REPLY) == (jrn._MAX_FRAME, jrn._MAX_REPLY)
    srv = jrn.RssNetServer(jrss.LocalRssService())
    try:  # the port's client against the JAX daemon
        cl = RN.RssNetClient(srv.addr)
        w = RN.RemotePartitionWriter(cl, "mix", 0)
        w.write(1, struct.pack("<Q", 3) + b"abc")
        w.flush()
        assert cl.fetch("mix", 1) == [struct.pack("<Q", 3) + b"abc"]
        cl.close()
    finally:
        srv.close()
