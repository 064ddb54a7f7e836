"""The port's memory manager (auron_tpu_torch/memory/memmgr.py) against
auron_tpu's: each protocol scenario runs on both managers, pinned to the
same budget, and must spill, wait and shrink the pool alike (the
reference's tests/test_memmgr.py and tests/test_runtime.py scenarios);
the spill containers round-trip batches bit for bit; a task unregisters
its consumers and removes its spill files on every path out."""

import glob
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from auron_tpu.memory import memmgr as JM
from auron_tpu.utils.config import Configuration as JConf
from auron_tpu.utils.config import conf_scope as jscope

from auron_tpu_torch import types as PT
from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator
from auron_tpu_torch.exec.basic import MemoryScanExec
from auron_tpu_torch.exec.sort_exec import SortExec
from auron_tpu_torch.exprs.ir import col
from auron_tpu_torch.memory import memmgr as PM
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.runtime.task import TaskRuntime
from auron_tpu_torch.utils.config import Configuration as PConf
from auron_tpu_torch.utils.config import conf_scope as pscope
from torch_carry import run_tree

#: (package tag, memmgr module, Configuration, conf_scope)
PACKAGES = {"jax": (JM, JConf, jscope), "port": (PM, PConf, pscope)}


@pytest.fixture(autouse=True)
def _restore_managers():
    try:
        yield
    finally:
        JM.MemManager.init()
        PM.MemManager.init()


class _FakeConsumer:
    def __init__(self, name, used=0):
        self.name = name
        self._used = used
        self.spill_calls = 0

    def mem_used(self):
        return self._used

    def spill(self):
        self.spill_calls += 1
        freed, self._used = self._used, 0
        return freed


def _manager(pkg: str, budget: int, **conf):
    M, Conf, scope = PACKAGES[pkg]
    c = Conf()
    for k, v in conf.items():
        c.set(k, v)
    with scope(c):
        mm = M.MemManager.init(budget_bytes=budget)
    mm.budget = budget  # ignore memory.fraction for the arithmetic
    return mm


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unspillable_shrinks_managed_pool(pkg):
    mm = _manager(pkg, 1000)
    build, a = _FakeConsumer("build", 600), _FakeConsumer("a", 100)
    mm.register(build, spillable=False)
    mm.register(a)
    # managed pool 1000 - 600 = 400, one spillable: fair max 400
    assert mm.mem_used_percent(a) == pytest.approx(100 / 400)
    mm.acquire(a, 350)  # 100 + 600 + 350 > 1000
    assert (build.spill_calls, a.spill_calls) == (0, 1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_update_mem_used_waits_for_release_then_proceeds(pkg):
    mm = _manager(pkg, 64 << 20, **{"memory.wait.timeout.seconds": 0.2})
    hog, small = _FakeConsumer("hog", 63 << 20), _FakeConsumer("small")
    mm.register(hog)
    mm.register(small)
    done = threading.Event()

    def grow():
        # over the pool, but under its min share (max 32 MB, min 4 MB): waits
        small._used = 2 << 20
        mm.update_mem_used(small, 0, 2 << 20)
        done.set()

    t = threading.Thread(target=grow)
    t.start()
    deadline = time.monotonic() + 5
    while mm.num_waits == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    hog._used = 0  # the sibling releases inside the wait
    mm.notify_released()
    t.join(timeout=5)
    assert done.is_set() and mm.num_waits == 1
    assert small.spill_calls == 0  # waited, never spilled


@pytest.mark.parametrize("pkg", PACKAGES)
def test_update_mem_used_timeout_forces_spill(pkg):
    mm = _manager(pkg, 64 << 20, **{"memory.wait.timeout.seconds": 0.2})
    hog, small = _FakeConsumer("hog", 63 << 20), _FakeConsumer("small")
    mm.register(hog)
    mm.register(small)
    small._used = 2 << 20
    t0 = time.monotonic()
    mm.update_mem_used(small, 0, 2 << 20)
    assert time.monotonic() - t0 >= 0.2
    assert (small.spill_calls, hog.spill_calls, mm.num_waits, mm.num_spills) == (1, 0, 1, 1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_self_spill_when_over_fair_share(pkg):
    mm = _manager(pkg, 10 << 20)
    a, b = _FakeConsumer("a"), _FakeConsumer("b")
    mm.register(a)
    mm.register(b)
    a._used = 6 << 20  # past its fair share of 5 MB
    mm.update_mem_used(a, 0, 6 << 20)
    assert (a.spill_calls, b.spill_calls, mm.num_waits) == (1, 0, 0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_spill_ordering(pkg):
    M = PACKAGES[pkg][0]
    mm = M.MemManager.init(budget_bytes=1000)
    assert mm.budget == 600  # x memory.fraction 0.6
    big, small = _FakeConsumer("big", 400), _FakeConsumer("small", 150)
    mm.register(big)
    mm.register(small)
    mm.acquire(small, 200)  # the largest other spills first
    assert (big.spill_calls, small.spill_calls, mm.total_used()) == (1, 0, 150)
    big2 = _FakeConsumer("big2", 550)
    mm.register(big2)
    mm.acquire(big2, 500)  # the requester spills when the others can't cover it
    assert (small.spill_calls, big2.spill_calls, mm.num_spills) == (1, 1, 3)
    snap = mm.mem_snapshot()
    assert snap["budget_bytes"] == 600 and snap["num_spills"] == 3
    assert [c["name"] for c in snap["consumers"]] == ["big", "small", "big2"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unregistered_victim_is_not_spilled(pkg):
    mm = _manager(pkg, 1000)
    a, b = _FakeConsumer("a", 900), _FakeConsumer("b", 50)
    mm.register(a)
    mm.register(b)
    mm.unregister(a)
    mm.acquire(b, 2000)
    assert (a.spill_calls, b.spill_calls) == (0, 1)


def test_auto_budget_matches_reference_on_cpu():
    """conf 0 = auto: half the physical RAM on the CPU, in both packages."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the port's auto budget is its memory")
    assert PM.MemManager(None).budget == JM.MemManager(None).budget > 0
    assert PM.MemManager(4096).budget == JM.MemManager(4096).budget == int(4096 * 0.6)


# ---------------------------------------------------------------------------
# spill containers
# ---------------------------------------------------------------------------

SCHEMA = PT.Schema((PT.Field("i", PT.INT64, True), PT.Field("f", PT.FLOAT64, True),
                    PT.Field("q", PT.INT32, True), PT.Field("b", PT.BOOL, True),
                    PT.Field("s", PT.STRING, True)))


def _batch(seed: int, n: int, cap: int | None = None) -> Batch:
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    f[:4] = [np.nan, -0.0, np.inf, -np.inf][: min(4, n)]
    s = np.empty(n, dtype=object)
    s[:] = rng.choice(["ab", "", "zz", "é"], n)
    cols = [rng.integers(-(2**62), 2**62, n), f, rng.integers(-5, 5, n).astype(np.int32),
            rng.random(n) < 0.5, s]
    valid = [rng.random(n) > 0.2 for _ in cols]
    return Batch.from_numpy(cols, SCHEMA, valid, capacity=cap, device="cpu")


def _planes(b: Batch):
    """Live rows' value bits (dictionary columns decoded) and validity."""
    out = []
    for (v, m), f in zip(b.to_numpy().values(), SCHEMA):
        if f.dtype.is_dict_encoded:
            out.append((list(v), m.tolist()))
        else:
            out.append((np.where(m, v, 0).view(np.uint8).tobytes(), m.tolist()))
    return out


@pytest.mark.parametrize("tier", ["disk", "host", "host_demoted"])
def test_spill_container_round_trip_bit_for_bit(tier, tmp_path):
    budget = 1 if tier == "host_demoted" else 1 << 30
    conf = PConf({"memory.host.spill.budget.bytes": budget})
    sp = (PM.DiskSpill(str(tmp_path), conf=conf) if tier == "disk"
          else PM.HostSpill(str(tmp_path), conf=conf))
    written = [_batch(1, 1000, cap=2048), _batch(2, 1)]
    for b in written:
        sp.write_batch(b)
    if tier != "disk":
        assert sp.demoted == (tier == "host_demoted")
    back = list(sp.read_batches(SCHEMA, "cpu"))
    assert [b.capacity for b in back] == [1024, 128]
    for got, want in zip(back, written):
        assert _planes(got) == _planes(want)
    assert len(glob.glob(str(tmp_path / "*.spill"))) == (tier != "host")
    sp.release()
    assert glob.glob(str(tmp_path / "*.spill")) == []


def test_host_ledger_demotes_coldest_first(tmp_path):
    """Past the host budget the OLDEST resident spills demote, only as many
    as clear the shortfall; the ledger forgets their bytes."""
    before = PM._host_ledger.resident_bytes()
    b = _batch(3, 5000)
    one = len(PM.encode_batch(b, PConf({})))  # a block as the spills write it: default codec
    conf = PConf({"memory.host.spill.budget.bytes": before + 3 * one + one // 2})
    spills = [PM.make_spill(str(tmp_path), conf=conf) for _ in range(3)]
    stats0 = dict(PM.SPILL_STATS)
    for sp in spills:
        sp.write_batch(b)
    assert [sp.demoted for sp in spills] == [False, False, False]
    spills[0].write_batch(b)  # 4 blocks > 3.5: the oldest spill demotes
    assert [sp.demoted for sp in spills] == [True, False, False]
    assert PM._host_ledger.resident_bytes() - before == 2 * one
    assert PM.SPILL_STATS["demotions"] - stats0["demotions"] == 1
    assert PM.SPILL_STATS["demoted_bytes"] - stats0["demoted_bytes"] == 2 * one
    assert sum(x.num_rows() for x in spills[0].read_batches(SCHEMA, "cpu")) == 10000
    for sp in spills:
        sp.release()
    assert PM._host_ledger.resident_bytes() == before


def test_spilled_rows_read_by_reference_decoder():
    """A spill block is a v2 shuffle block: the JAX package decodes it."""
    from auron_tpu.exec.shuffle.format import decode_blocks

    b = _batch(4, 700)
    got = [rb.to_pydict() for rb in decode_blocks(PM.encode_batch(b, None))]
    assert len(got) == 1
    assert got[0] == b.to_pydict() | {"f": got[0]["f"]}
    want_f = b.to_pydict()["f"]
    assert all((x is None and y is None) or (np.isnan(x) and np.isnan(y)) or x == y
               for x, y in zip(got[0]["f"], want_f))


# ---------------------------------------------------------------------------
# a task's consumers, on every path out
# ---------------------------------------------------------------------------


class _Boom(ExecOperator):
    """Passes ``n_ok`` batches through, then raises."""

    def __init__(self, child, n_ok):
        super().__init__([child], child.schema)
        self.n_ok = n_ok

    def _execute(self, partition, ctx):
        for i, b in enumerate(self.child_stream(0, partition, ctx)):
            if i == self.n_ok:
                raise ValueError("boom")
            yield b


def _sort_tree(n_ok=None, threshold=1 << 23):
    batches = [_batch(10 + i, 300) for i in range(6)]
    child = MemoryScanExec([batches], SCHEMA)
    if n_ok is not None:
        child = _Boom(child, n_ok)
    return SortExec(child, [col(0)], [SortSpec()], spill_threshold_rows=threshold)


def test_task_unregisters_consumers_on_success_error_and_cancel():
    mm = PM.MemManager.init(budget_bytes=1 << 30)
    out, metrics = run_tree(_sort_tree(threshold=500), {}, device="cpu")
    assert sum(b.num_rows() for b in out) == 1800
    assert metrics["values"]["spilled_runs"] == 3
    assert mm.mem_snapshot()["consumers"] == []
    with pytest.raises(RuntimeError, match="failed"):
        run_tree(_sort_tree(n_ok=3), {}, device="cpu")
    assert mm.mem_snapshot()["consumers"] == []
    rt = TaskRuntime(_sort_tree(), device="cpu")
    rt.finalize()  # cancel, whatever the pump reached
    assert mm.mem_snapshot()["consumers"] == []


def test_abandoned_stream_releases_consumers():
    """A join whose consumer stops pulling never reaches its own finally:
    its build guard stays registered until the task's consumers are
    released, which unregisters (and releases) them once."""
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    mm = PM.MemManager.init(budget_bytes=1 << 30)
    ctx = ExecutionContext(device="cpu")
    probe = MemoryScanExec([[_batch(30 + i, 300) for i in range(3)]], SCHEMA)
    join = BroadcastHashJoinExec(probe, probe, [col(2)], [col(2)], "inner")
    stream = join.execute(0, ctx)
    next(stream)
    assert [c["name"][:10] for c in mm.mem_snapshot()["consumers"]] == ["join-build"]
    holder = _Holder()
    PM.register(ctx, holder)
    PM.release_task_consumers(ctx)
    assert mm.mem_snapshot()["consumers"] == [] and holder.released == 1
    PM.release_task_consumers(ctx)  # idempotent
    assert holder.released == 1
    stream.close()


class _Holder(_FakeConsumer):
    def __init__(self):
        super().__init__("holder", 10)
        self.released = 0

    def release(self):
        self.released += 1


def test_bridge_init_memory_sets_the_budget():
    mm = papi.init_memory(1 << 20, conf={"memory.fraction": 0.5,
                                         "memory.wait.timeout.seconds": 0.1})
    assert PM.MemManager.get() is mm and mm.budget == 1 << 19
    assert mm._wait_timeout == 0.1
    assert mm.mem_snapshot() == {"budget_bytes": 1 << 19, "num_spills": 0, "num_waits": 0,
                                 "consumers": []}


def test_no_spill_file_outlives_its_task(tmp_path, monkeypatch):
    """Budgeted sort, aggregate and shuffle tasks, one of them failing:
    no ``.spill`` or ``.shuffle.spill`` file is left in the temp dir."""
    from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, AggExpr, HashAggExec
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    conf = PConf({"memory.host.spill.budget.bytes": 1})  # every host spill demotes
    with pscope(conf):
        PM.MemManager.init(budget_bytes=4096)
    batches = [_batch(20 + i, 400) for i in range(5)]
    scan = MemoryScanExec([batches], SCHEMA)
    agg = HashAggExec(HashAggExec(scan, [(col(0), "i")], [(AggExpr("sum", col(1)), "s")],
                                  PARTIAL),
                      [(col(0), "i")], [(AggExpr("sum", col(1)), "s")], FINAL)
    _, m = run_tree(agg, {}, conf=conf, device="cpu")
    assert m["children"][0]["values"]["spilled_aggs"] > 0
    writer = ShuffleWriterExec(scan, HashPartitioning([col(0)], 3),
                               str(tmp_path / "out.data"), str(tmp_path / "out.index"))
    _, m = run_tree(writer, {}, conf=conf, device="cpu")
    assert m["values"]["spilled_shuffle_runs"] > 0
    with pytest.raises(RuntimeError):
        run_tree(ShuffleWriterExec(_Boom(scan, 3), HashPartitioning([col(0)], 3),
                                   str(tmp_path / "x.data"), str(tmp_path / "x.index")),
                 {}, conf=conf, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["out.data", "out.index"]


class _LockedConsumer:
    """A consumer whose usage and spill are guarded by its own lock, as the
    operators' are (the manager's lock is taken first)."""

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._used = self.added = self.freed = self.spills = 0

    def add(self, n):
        with self._lock:
            self._used += n
            self.added += n

    def mem_used(self):
        with self._lock:
            return self._used

    def spill(self):
        with self._lock:
            freed, self._used = self._used, 0
            self.freed += freed
            self.spills += bool(freed)
            return freed


def test_concurrent_acquire_and_spill_keep_the_books():
    """Many task threads acquire and grow at once under a small budget,
    each spilling the others: no update is lost (every consumer's bytes
    added = freed + still held) and the manager counted every spill that
    freed bytes once."""
    import sys

    mm = PM.MemManager.init(budget_bytes=50_000)
    consumers = [_LockedConsumer(f"c{i}") for i in range(2 * (os.cpu_count() or 4))]
    for c in consumers:
        mm.register(c)
    errors = []

    def work(c, seed):
        rng = np.random.default_rng(seed)
        try:
            for n in rng.integers(100, 3000, 300).tolist():
                mm.acquire(c, n)
                c.add(n)
        except BaseException as e:  # noqa: BLE001 — reported by the test below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(c, i)) for i, c in enumerate(consumers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    for c in consumers:
        assert c.added == c.freed + c.mem_used(), c.name
    assert mm.num_spills == sum(c.spills for c in consumers) > 0
