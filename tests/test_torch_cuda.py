"""On-card tests of the port (marked ``cuda``; each skips without a GPU).

This file imports only torch, numpy and auron_tpu_torch, so it also runs
on a machine without JAX. There, skip the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import glob
import tempfile

import numpy as np
import pytest
import torch

from auron_tpu_torch.ops import bitonic as pb
from auron_tpu_torch.ops import partition_kernels as pk


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@contextlib.contextmanager
def _recording_kernel_shapes(shapes: list):
    """(NP, P) of each kernel sort and (NP, P, True) of each kernel merge of
    spilled runs inside the block: ``pb.sort_plan(*shape)`` lists its launches."""
    real_sort, real_merge = pb.kernel_sort_, pb.kernel_merge_

    def sorting(x32):
        shapes.append(tuple(x32.shape))
        return real_sort(x32)

    def merging(x32):
        shapes.append((*x32.shape, True))
        return real_merge(x32)

    pb.kernel_sort_, pb.kernel_merge_ = sorting, merging
    try:
        yield
    finally:
        pb.kernel_sort_, pb.kernel_merge_ = real_sort, real_merge


def _planes(rng, NP, P, tie_range):
    out = np.empty((NP, P), dtype=np.int64)
    for p in range(NP - 1):
        out[p] = rng.integers(0, tie_range if p == 0 else 2**32, P, dtype=np.int64)
    out[NP - 1] = rng.permutation(P)
    return out


_PATTERNS = ("ties", "equal_lead", "sorted", "reversed")


def _sweep_planes(rng, NP, P, pattern):
    """(NP, P) uint32 planes as int64 carriers, the last a distinct payload:
    'ties' (every key plane in 0..2), 'equal_lead' (one value in the leading
    plane), or random planes already 'sorted' or 'reversed'."""
    hi = 3 if pattern == "ties" else 2**32
    out = _planes(rng, NP, P, hi)
    if pattern == "ties":
        out[: NP - 1] = rng.integers(0, 3, (NP - 1, P))
    if pattern == "equal_lead":
        out[0] = 7
    if pattern in ("sorted", "reversed"):
        out = out[:, np.lexsort(tuple(out[::-1]))]
        if pattern == "reversed":
            out = np.ascontiguousarray(out[:, ::-1])
    return out


def _bitonic_of(planes):
    half = planes.shape[1] // 2
    a = planes[:, :half][:, np.lexsort(tuple(planes[::-1, :half]))]
    b = planes[:, half:][:, np.lexsort(tuple(planes[::-1, half:]))][:, ::-1]
    return np.ascontiguousarray(np.concatenate([a, b], axis=1))


def _assert_sort_and_merge(rng, NP, P, pattern):
    host = _sweep_planes(rng, NP, P, pattern)
    want = host[:, np.lexsort(tuple(host[::-1]))]
    x = torch.from_numpy(host).cuda()
    got = pb._run(x, P, "pallas", merge=False)
    assert np.array_equal(got.cpu().numpy(), want), ("sort vs numpy", NP, P, pattern)
    assert torch.equal(got, pb._network(x, P)), ("sort vs plain", NP, P, pattern)
    bit = torch.from_numpy(_bitonic_of(host)).cuda()
    merged = pb.bitonic_merge(bit, impl="pallas")
    assert np.array_equal(merged.cpu().numpy(), want), ("merge vs numpy", NP, P, pattern)
    assert torch.equal(merged, pb._merge_network(bit, P)), ("merge vs plain", NP, P, pattern)


@pytest.mark.cuda
@pytest.mark.parametrize("NP", range(2, pb._MAX_NP + 2))
def test_kernels_match_plain_network_on_card(NP):
    """Every plane count with a register kernel and one past it (the
    general kernels), at P from a cluster of 2 CTAs to twice the largest
    single-cluster sort (32,768), the input patterns in turn: sort
    bit-equal to the plain network and numpy, merge to the plain merge
    network."""
    _need_card()
    rng = np.random.default_rng(NP)
    for i, P in enumerate((1024, 2048, 8192, 16384, 32768, 65536)):
        _assert_sort_and_merge(rng, NP, P, _PATTERNS[(NP + i) % len(_PATTERNS)])


@pytest.mark.cuda
@pytest.mark.parametrize("NP,P", [(8, 1 << 20), (13, 1 << 18), (17, 1 << 18)])
def test_kernels_past_one_cluster_on_card(NP, P):
    """The multi-stride merge launches (and, at 17 planes, the general
    kernels) at large P."""
    _need_card()
    _assert_sort_and_merge(np.random.default_rng(P + NP), NP, P, "ties")


@pytest.mark.cuda
@pytest.mark.parametrize("NP", [2, 8, 16, 17])
def test_kernels_below_the_padded_length_on_card(NP):
    """kernel_sort_ / kernel_merge_ called directly at P below the 1024
    that bitonic_sort pads to: one small CTA (128..512) or, under 128, the
    general kernels."""
    _need_card()
    rng = np.random.default_rng(200 + NP)
    for P in (2, 64, 128, 256, 512):
        _assert_sort_and_merge(rng, NP, P, "ties")


@pytest.mark.cuda
def test_sort_plan_launches_on_card():
    """kernel_sort_ counts exactly the launches sort_plan lists."""
    _need_card()
    for NP, P in ((8, 16384), (11, 16384), (11, 8192), (8, 1 << 20), (17, 16384)):
        x = torch.zeros((NP, P), dtype=torch.int32, device="cuda")
        before = dict(pb.LAUNCHES)
        pb.kernel_sort_(x)
        torch.cuda.synchronize()
        got = {k: pb.LAUNCHES[k] - before[k] for k in before}
        assert got == pb.sort_plan(NP, P).launch_counts(), (NP, P, got)


@pytest.mark.cuda
@pytest.mark.parametrize("NP", [2, 8, 11, 16, 17])
def test_padded_operand_sort_on_card(NP):
    """Operands of cap = P - 3 rows (the -1 padding sorts last) at every
    sweep length: equal to the plain network and the library lexsort."""
    _need_card()
    rng = np.random.default_rng(100 + NP)
    for P in (1024, 2048, 8192, 16384, 32768, 65536):
        cap = P - 3
        ops = tuple(torch.from_numpy(rng.integers(-3, 3, cap).astype(np.int32)).cuda()
                    for _ in range(NP - 1)) + (torch.arange(cap, dtype=torch.int32,
                                                            device="cuda"),)
        got = pb.bitonic_sort(ops, impl="pallas")
        ref = pb.bitonic_sort(ops, impl="jnp")
        want = pb.lex_sorted(ops)
        for g, r, w in zip(got, ref, want):
            assert torch.equal(g, r) and torch.equal(g, w), (NP, P)


@pytest.mark.cuda
def test_operand_sort_on_card_matches_plain_and_lexsort():
    """bitonic_sort on CUDA operands (int32 planes split and joined on the
    card) equals the plain network and the library lexsort."""
    _need_card()
    rng = np.random.default_rng(2)
    cap = 5000
    ops = (torch.from_numpy((rng.random(cap) < 0.2).astype(np.int64)).cuda(),
           torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, cap, dtype=np.int64)).cuda(),
           torch.from_numpy(rng.integers(-8, 8, cap, dtype=np.int64)).cuda(),
           torch.from_numpy(rng.integers(-5, 5, cap).astype(np.int32)).cuda(),
           torch.arange(cap, dtype=torch.int32, device="cuda"))
    kinds = ("u64", "u64", "i64", "i32", "i32")
    narrow = (True, False, False, False, False)
    got = pb.bitonic_sort(ops, impl="pallas", narrow=narrow, kinds=kinds)
    ref = pb.bitonic_sort(ops, impl="jnp", narrow=narrow, kinds=kinds)
    want = pb.lex_sorted(ops, kinds)
    for g, r, w in zip(got, ref, want):
        assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w)


@pytest.mark.cuda
def test_q42_on_card_goes_through_the_kernels():
    """A small q42-class run on cuda equals the numpy oracle exactly in
    brand and order, and its SortExec launched exactly the bitonic kernels
    that sort_plan lists for the shapes it sorted."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    shapes = []
    real = pb.kernel_sort_

    def recording(x32):
        shapes.append(tuple(x32.shape))
        return real(x32)

    before = dict(pb.LAUNCHES)
    pb.kernel_sort_ = recording
    try:
        got = tpcds.run_q42_class(data, device="cuda")
    finally:
        pb.kernel_sort_ = real
    want = tpcds.q42_class_oracle(data)
    np.testing.assert_array_equal(got["brand"], want["brand"])
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
    planned = {k: sum(pb.sort_plan(*s).launch_counts()[k] for s in shapes) for k in before}
    assert shapes and planned["bitonic_sort"] == len(shapes), shapes
    assert {k: pb.LAUNCHES[k] - before[k] for k in before} == planned, (shapes, pb.LAUNCHES)


@pytest.mark.cuda
def test_partition_kernel_matches_plain_on_card():
    """K1 bit-equal to its plain version: negative hashes, INT64_MIN/MAX,
    0 and -1, NULL keys, one and non-power-of-two partition counts, ragged
    lengths."""
    _need_card()
    rng = np.random.default_rng(3)
    for n in (1, 255, 257, 100_003):
        keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
        keys[: min(n, 4)] = np.array([-(2**63), 2**63 - 1, 0, -1])[: min(n, 4)]
        k = torch.from_numpy(keys).cuda()
        valid = torch.from_numpy(rng.random(n) > 0.5).cuda()
        for n_parts in (1, 3, 4, 200, 4096):
            got = pk.partition_ids(k, valid, n_parts)
            assert torch.equal(got, pk.plain_partition_ids(k, valid, n_parts)), (n, n_parts)
            assert bool((got[~valid] == 42 % n_parts).all())


@pytest.mark.cuda
def test_two_stage_queries_on_card_go_through_k1():
    """Small q93- and q3-class runs on cuda equal their numpy oracles, and
    q93's shuffle writer launched K1."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    before = pk.LAUNCHES["murmur3_pmod"]
    got = tpcds.run_q93_class(data, device="cuda")
    want = tpcds.q93_class_oracle(data)
    assert pk.LAUNCHES["murmur3_pmod"] > before
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    q3 = tpcds.run_q3_class(data, device="cuda")
    o3 = tpcds.q3_class_oracle(data)
    np.testing.assert_array_equal(q3["i_brand_id"], o3["i_brand_id"])
    np.testing.assert_allclose(q3["s"], o3["s"], rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_histogram_kernel_matches_plain_on_card():
    """K2 bit-equal to its plain version and numpy: out-of-range ids (-1,
    n_parts, INT32_MIN/MAX), dead rows, no sel, n = 0, one partition, and
    a count past the shared-memory branch."""
    _need_card()
    rng = np.random.default_rng(4)
    shared = pk.histogram_shared_parts()
    for n in (0, 1, 257, 100_003):
        for n_parts in (1, 2, 7, 4096, shared + 1):
            pids = rng.integers(-3, n_parts + 3, n).astype(np.int32)
            edges = np.array([-1, -(2**31), 2**31 - 1, n_parts], np.int32)[: min(n, 4)]
            pids[: len(edges)] = edges
            live = rng.random(n) < 0.6
            p, s = torch.from_numpy(pids).cuda(), torch.from_numpy(live).cuda()
            got = pk.partition_histogram(p, n_parts, s)
            assert torch.equal(got, pk.plain_partition_histogram(p, n_parts, s)), (n, n_parts)
            keep = live & (pids >= 0) & (pids < n_parts)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.bincount(pids[keep], minlength=n_parts))
            assert torch.equal(pk.partition_histogram(p, n_parts),
                               pk.plain_partition_histogram(p, n_parts))


@pytest.mark.cuda
def test_mesh_driver_queries_on_card_go_through_k2():
    """q93- and q3-class through the planned-exchange driver on 4 logical
    partitions, both transports: equal to the numpy oracles, and K2
    launched once per source shard."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    w93, w3 = tpcds.q93_class_oracle(data), tpcds.q3_class_oracle(data)
    for mode in ("mesh", "file"):
        before = pk.LAUNCHES["partition_histogram"]
        got = tpcds.run_q93_mesh(data, conf={"exchange.mode": mode})
        assert pk.LAUNCHES["partition_histogram"] - before == 4
        np.testing.assert_array_equal(got["rows"], w93["rows"])
        np.testing.assert_array_equal(got["matched"], w93["matched"])
        np.testing.assert_allclose(got["s"], w93["s"], rtol=1e-9, atol=0)
        q3 = tpcds.run_q3_mesh(data, conf={"exchange.mode": mode})
        np.testing.assert_array_equal(q3["d_year"], w3["d_year"])
        np.testing.assert_array_equal(q3["i_brand_id"], w3["i_brand_id"])
        np.testing.assert_allclose(q3["s"], w3["s"], rtol=1e-9, atol=0)


def _assert_answer(got: dict, want: dict) -> None:
    for k, w in want.items():
        if k in ("p_avg", "q_avg", "p_sum", "a", "s"):
            np.testing.assert_allclose(got[k], w, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(got[k], w)


@pytest.mark.cuda
def test_gate_classes_on_card_go_through_the_kernels():
    """The six gate classes on cuda equal their numpy oracles; q72 under
    elision mode build sorts its probe side through K3/K4 with exactly the
    launches sort_plan lists, and every single-INT64-key shuffle launches K1."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    for name, conf in (("q72", {"auron.smj.elide.sorts": "build"}), ("q72", None),
                       ("q95", None), ("q18", None), ("q14", None), ("q65", None),
                       ("q5", None)):
        shapes = []
        before = {**pb.LAUNCHES, **pk.LAUNCHES}
        with _recording_kernel_shapes(shapes):
            got = getattr(tpcds, f"run_{name}_class")(data, conf=conf)
        launched = {k: v - before[k] for k, v in {**pb.LAUNCHES, **pk.LAUNCHES}.items()}
        _assert_answer(got, getattr(tpcds, f"{name}_class_oracle")(data))
        # the sorts' launches plus those of any merge of spilled runs
        planned = {k: sum(pb.sort_plan(*s).launch_counts()[k] for s in shapes)
                   for k in pb.LAUNCHES}
        assert {k: launched[k] for k in pb.LAUNCHES} == planned, (name, conf, shapes)
        assert any(len(s) == 2 for s in shapes) == (conf is not None), (name, conf, shapes)
        assert (launched["murmur3_pmod"] > 0) == (name not in ("q18", "q14")), (name, launched)


@pytest.mark.cuda
def test_smj_stages_on_card_through_the_driver():
    """q72-mesh on both transports equals the oracle with K2 once per
    source shard of each exchange; the skew plan splits its hot partition
    and sorts its slices through K3/K4."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    want = tpcds.q72_class_oracle(data)
    for mode in ("mesh", "file"):
        st = {}
        got = tpcds.run_q72_mesh(data, conf={"exchange.mode": mode}, stats=st)
        _assert_answer(got, want)
        assert st["launches"]["partition_histogram"] == sum(
            len(ex["routing"]) for ex in st["exchanges"])
    fact, dim = tpcds.skew_data(200_000, 0.7)
    before = dict(pb.LAUNCHES)
    st = {}
    got = tpcds.run_skew_join(fact, dim, stats=st)
    _assert_answer(got, tpcds.skew_join_oracle(fact, dim))
    assert len(st["exchanges"][0]["skew_tasks"]) > 4
    assert pb.LAUNCHES["bitonic_sort"] > before["bitonic_sort"]


@pytest.mark.cuda
def test_window_on_card_matches_its_cpu_run():
    """A WindowExec over 5,000 rows (P = 8,192: the kernels' range) on the
    card equals its CPU run: ranks, lag, counts and min/max exactly, the
    running and whole sums at rel 1e-9 plus 16 eps of the global prefix;
    its sort went through K3."""
    _need_card()
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.window_exec import WindowExec, WindowFunc
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.ops.sortkeys import SortSpec

    rng = np.random.default_rng(9)
    n = 5000
    cols = [rng.integers(0, 40, n).astype(np.int64), rng.integers(0, 300, n).astype(np.int32),
            np.round(rng.gamma(2.0, 25.0, n), 2)]
    valid = [None, None, rng.random(n) > 0.05]
    schema = T.Schema((T.Field("g", T.INT64), T.Field("o", T.INT32), T.Field("v", T.FLOAT64)))
    funcs = [(WindowFunc(k, agg=a, expr=None if c is None else col(c), offset=o,
                         frame_whole=w), name)
             for name, k, a, c, o, w in (
                 ("rk", "rank", None, None, 1, False), ("dr", "dense_rank", None, None, 1, False),
                 ("nt", "ntile", None, None, 4, False), ("lg", "lag", None, 2, 1, False),
                 ("rs", "agg", "sum", 2, 1, False), ("rc", "agg", "count", 2, 1, False),
                 ("rmin", "agg", "min", 2, 1, False), ("tmax", "agg", "max", 2, 1, True),
                 ("ts", "agg", "sum", 2, 1, True))]
    out = {}
    before = dict(pb.LAUNCHES)
    for dev in ("cpu", "cuda"):
        b = Batch.from_numpy(cols, schema, valid, device=dev)
        w = WindowExec(MemoryScanExec([[b]], schema), [col(0)],
                       [(col(1), SortSpec(asc=False))], funcs)
        got = list(w.execute(0, ExecutionContext(device=dev)))
        out[dev] = {k: v for k, v in got[0].to_numpy().items()}
    assert pb.LAUNCHES["bitonic_sort"] > before["bitonic_sort"]
    g_prefix = np.cumsum(np.where(out["cpu"]["v"][1], out["cpu"]["v"][0], 0.0))
    eps = np.finfo(np.float64).eps
    for name, (want, want_ok) in out["cpu"].items():
        got, got_ok = out["cuda"][name]
        np.testing.assert_array_equal(got_ok, want_ok, err_msg=name)
        if name in ("rs", "ts"):
            bound = 1e-9 * np.abs(want) + 16 * eps * g_prefix[-1]
            assert (np.abs(got - want)[want_ok] <= bound[want_ok]).all(), name
        else:
            np.testing.assert_array_equal(got[want_ok], want[want_ok], err_msg=name)


# ---------------------------------------------------------------------------
# spills (memory/memmgr.py and its consumers)
# ---------------------------------------------------------------------------


def _spill_batches(device, n_batches=6, n=20_000, seed=5):
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch

    rng = np.random.default_rng(seed)
    schema = T.Schema((T.Field("k", T.INT64), T.Field("v", T.FLOAT64), T.Field("r", T.INT64)))
    out = []
    for i in range(n_batches):
        cols = [rng.integers(0, 2000, n) * 1_000_003, np.round(rng.normal(size=n), 3),
                np.arange(i * n, (i + 1) * n, dtype=np.int64)]
        out.append(Batch.from_numpy(cols, schema, [None, rng.random(n) > 0.1, None],
                                    device=device))
    return schema, out


@pytest.mark.cuda
def test_spilled_sort_merges_runs_on_card():
    """A SortExec whose runs spill (ties everywhere) gives its CPU run's rows
    on the card; each run merge goes through K4, bit-equal to the plain
    network on the same bitonic sequence, with sort_plan's launches."""
    _need_card()
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.sort_exec import SortExec
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.ops.sortkeys import SortSpec
    from auron_tpu_torch.ops.uwords import MASK32, u32_of_i32

    out, merges, shapes = {}, [], []
    real = pb.merge_sorted_planes

    def recording(a, b):
        merges.append((a.clone(), b.clone()))
        return real(a, b)

    for dev in ("cpu", "cuda"):
        schema, batches = _spill_batches(dev)
        ctx = ExecutionContext(device=dev)
        op = SortExec(MemoryScanExec([batches], schema), [col(0)], [SortSpec(asc=False)],
                      spill_threshold_rows=30_000)
        before = dict(pb.LAUNCHES)
        pb.merge_sorted_planes = recording
        try:
            with _recording_kernel_shapes(shapes):
                got = list(op.execute(0, ctx))
        finally:
            pb.merge_sorted_planes = real
        out[dev] = [b.to_numpy() for b in got]
        assert ctx.metrics.values["spilled_runs"] == 3
        launched = {k: pb.LAUNCHES[k] - before[k] for k in before}
    assert len(out["cpu"]) == len(out["cuda"])
    for c, g in zip(out["cpu"], out["cuda"]):
        for name in c:
            np.testing.assert_array_equal(g[name][0], c[name][0], err_msg=name)
            np.testing.assert_array_equal(g[name][1], c[name][1], err_msg=name)
    assert [s for s in shapes if len(s) == 3], shapes  # run merges on the card
    planned = {k: sum(pb.sort_plan(*s).launch_counts()[k] for s in shapes) for k in pb.LAUNCHES}
    assert launched == planned, (shapes, launched)
    cuda_merges = [(a, b) for a, b in merges if a.is_cuda]
    assert len(cuda_merges) == 2
    for a, b in cuda_merges:
        n = a.shape[1] + b.shape[1]
        P = max(pb._next_pow2(n), 1024)
        x = torch.full((a.shape[0], P), MASK32, dtype=torch.int64, device="cuda")
        x[:, :a.shape[1]] = u32_of_i32(a)
        x[:, P - b.shape[1]:] = u32_of_i32(b).flip(1)
        assert torch.equal(u32_of_i32(pb.merge_sorted_planes(a, b)),
                           pb._merge_network(x, P)[:, :n])


@pytest.mark.cuda
def test_budgeted_aggregate_on_card_matches_its_cpu_run():
    """A partial + final aggregate under a budget that parks several runs:
    the card's groups equal the CPU run's under the same budget (keys and
    counts exactly, sums at rel 1e-9), and both spilled."""
    _need_card()
    from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.runtime.task import run_task

    out = {}
    try:
        for dev in ("cpu", "cuda"):
            MemManager.init(budget_bytes=200_000)
            schema, batches = _spill_batches(dev)
            aggs = [(AggExpr("sum", col(1)), "s"), (AggExpr("count_star"), "n")]
            partial = HashAggExec(MemoryScanExec([batches], schema), [(col(0), "k")], aggs,
                                  PARTIAL)
            final = HashAggExec(partial, [(col(0), "k")],
                                [(AggExpr("sum", col(1)), "s"), (AggExpr("count", col(2)), "n")],
                                FINAL)
            got, metrics = run_task(final, {}, device=dev)
            assert metrics["children"][0]["values"]["spilled_aggs"] >= 2, metrics
            cols = {}
            for b in got:
                for name, (v, m) in b.to_numpy().items():
                    cols.setdefault(name, []).append(np.where(m, v, 0))
            cols = {k: np.concatenate(v) for k, v in cols.items()}
            order = np.argsort(cols["k"], kind="stable")
            out[dev] = {k: v[order] for k, v in cols.items()}
    finally:
        MemManager.init()
    np.testing.assert_array_equal(out["cuda"]["k"], out["cpu"]["k"])
    np.testing.assert_array_equal(out["cuda"]["n"], out["cpu"]["n"])
    np.testing.assert_allclose(out["cuda"]["s"], out["cpu"]["s"], rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_no_spill_file_outlives_its_task_on_card(tmp_path, monkeypatch):
    """Budgeted tasks on the card whose sort, aggregate and shuffle staging
    spill to disk, one of them cancelled mid-stream: no .spill or
    .shuffle.spill file is left behind."""
    _need_card()
    from auron_tpu_torch.exec.agg_exec import PARTIAL, AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.exec.sort_exec import SortExec
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.ops.sortkeys import SortSpec
    from auron_tpu_torch.runtime.task import TaskRuntime, run_task
    from auron_tpu_torch.utils.config import Configuration, conf_scope

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    conf = Configuration({"memory.host.spill.budget.bytes": 1})  # host spills demote to disk
    schema, batches = _spill_batches("cuda")
    scan = MemoryScanExec([batches], schema)
    try:
        with conf_scope(conf):
            MemManager.init(budget_bytes=200_000)
        _, m = run_task(HashAggExec(scan, [(col(0), "k")], [(AggExpr("sum", col(1)), "s")],
                                    PARTIAL), {}, conf=conf, device="cuda")
        assert m["values"]["spilled_aggs"] >= 1
        _, m = run_task(SortExec(scan, [col(0)], [SortSpec()]), {}, conf=conf, device="cuda")
        assert m["values"]["spilled_runs"] >= 2
        writer = ShuffleWriterExec(scan, HashPartitioning([col(0)], 4),
                                   str(tmp_path / "o.data"), str(tmp_path / "o.index"))
        _, m = run_task(writer, {}, conf=conf, device="cuda")
        assert m["values"]["spilled_shuffle_runs"] >= 2
        rt = TaskRuntime(HashAggExec(scan, [(col(0), "k")], [(AggExpr("sum", col(1)), "s")],
                                     PARTIAL), conf=conf, device="cuda")
        rt.finalize()
    finally:
        MemManager.init()
    assert sorted(glob.glob(str(tmp_path / "*spill*"))) == []


@pytest.mark.cuda
def test_transfer_window_on_card():
    """CUDA tensors go through pinned host memory behind one event a push;
    FIFO order and depth as on the CPU, every value right after its harvest."""
    from auron_tpu_torch.exec.metrics import MetricNode
    from auron_tpu_torch.runtime.transfer import TransferWindow, start_host_transfer

    _need_card()
    tr = start_host_transfer(torch.arange(5, device="cuda"), torch.tensor(3))
    assert tr.host[0].is_pinned() and tr.event is not None
    assert tr.host[1].device.type == "cpu"
    m = MetricNode("w")
    w = TransferWindow(3, m)
    got = []
    for i in range(40):
        x = torch.full((1 << 20,), i, device="cuda").cumsum(0)  # device work behind the copy
        for resolved, payload in w.push((x[-1], x[:4]), i):
            got.append((int(resolved[0]), resolved[1].tolist(), payload))
        assert len(w) == min(i + 1, 3)
    got += [(int(r[0]), r[1].tolist(), p) for r, p in w.drain()]
    assert got == [(i * (1 << 20), [i, 2 * i, 3 * i, 4 * i], i) for i in range(40)]
    assert sum(m.values.values()) == 40


@pytest.mark.cuda
@pytest.mark.parametrize("n,out_cap", [(128, 128), (1 << 20, 1 << 14), (1 << 20, 1 << 20),
                                       (3000, 1024)])
def test_compaction_index_on_card_matches_cpu(n, out_cap):
    from auron_tpu_torch.columnar.batch import compaction_index

    _need_card()
    rng = np.random.default_rng(n + out_cap)
    for share in (0.0, 0.001, 0.3, 1.0):
        sel = torch.from_numpy(rng.random(n) < share)
        idx_c, sel_c = compaction_index(sel, out_cap)
        idx_g, sel_g = compaction_index(sel.cuda(), out_cap)
        assert torch.equal(idx_g.cpu(), idx_c) and torch.equal(sel_g.cpu(), sel_c)
        live = np.flatnonzero(sel.numpy())[:out_cap]
        assert idx_c[:len(live)].tolist() == live.tolist()
        assert int(sel_c.sum()) == len(live)


@pytest.mark.cuda
def test_predicted_joins_on_card_match_their_cpu_runs():
    """q33 (a full join) and q3 (a fused chain) on the card equal their
    oracles with the predictor on and off, and each unique-probe stream
    makes one blocking read with it on."""
    from auron_tpu_torch.models import tpcds

    _need_card()
    d = tpcds.generate(0.2, 42)
    for name, kw in (("q33", {}), ("q3", {"n_map": 2, "n_reduce": 2})):
        want = getattr(tpcds, f"{name}_class_oracle")(d)
        for mode in ("on", "off"):
            st: dict = {}
            got = getattr(tpcds, f"run_{name}_class")(
                d, device="cuda", conf={"exec.selectivity.predictor": mode}, stats=st, **kw)
            for k, w in want.items():
                np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                           np.asarray(w, dtype=np.float64), rtol=1e-9)
            c = st["counters"]
            if mode == "on":
                assert c["BroadcastHashJoinExec.blocking_reads"] == \
                    c["BroadcastHashJoinExec.unique_streams"], (name, c)


def _decimal_batches(dev, n_batches: int = 3, n: int = 5000):
    """(schema, batches): an int64 key, a decimal(9,2) price and a
    decimal(38,4) amount, on ``dev``."""
    import decimal as pydec

    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch

    schema = T.Schema((T.Field("k", T.INT64), T.Field("p", T.decimal(9, 2)),
                       T.Field("w", T.decimal(38, 4))))
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n_batches):
        k = rng.integers(0, 300, n) * 1_000_003
        cents = rng.integers(-(10**8), 10**8, n)
        wide = np.empty(n, dtype=object)
        wide[:] = [pydec.Decimal(int(x)).scaleb(-4) * 10**20 for x in rng.integers(1, 10**9, n)]
        valid = rng.random(n) > 0.1
        out.append(Batch.from_numpy([k, cents, wide], schema, [None, valid, valid], device=dev))
    return schema, out


@pytest.mark.cuda
def test_decimal_sums_on_card_match_their_cpu_run():
    """decimal64 and wide sums (base-1e9 limbs folded on the card), a
    decimal avg and wide min/max: the card's groups equal the CPU run's
    exactly."""
    _need_card()
    from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.runtime.task import run_task

    out = {}
    for dev in ("cpu", "cuda"):
        schema, batches = _decimal_batches(dev)
        aggs = [(AggExpr("sum", col(1)), "s"), (AggExpr("avg", col(1)), "a"),
                (AggExpr("sum", col(2)), "ws"), (AggExpr("max", col(2)), "wmax")]
        partial = HashAggExec(MemoryScanExec([batches], schema), [(col(0), "k")], aggs, PARTIAL)
        final = HashAggExec(partial, [(col(0), "k")], aggs, FINAL)
        got, _ = run_task(final, {}, device=dev)
        assert all(b.torch_device.type == dev for b in got)
        rows = sorted(r for b in got for r in zip(*b.to_pydict().values()))
        out[dev] = rows
    assert out["cuda"] == out["cpu"] and len(out["cpu"]) == 300


@pytest.mark.cuda
def test_dec128_shuffle_round_trip_from_card(tmp_path):
    """A decimal64 and a wide column written from CUDA tensors as DEC128
    planes read back with every row, on the card."""
    _need_card()
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec, MultiMapBlockProvider
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.exprs.ir import col

    schema, batches = _decimal_batches("cuda")
    d, i = str(tmp_path / "m.data"), str(tmp_path / "m.index")
    w = ShuffleWriterExec(MemoryScanExec([batches], schema), HashPartitioning([col(2)], 3), d, i)
    list(w.execute(0, ExecutionContext(device="cuda")))
    got = []
    for p in range(3):
        ctx = ExecutionContext(device="cuda", resources={"b": MultiMapBlockProvider([(d, i)])})
        for b in IpcReaderExec(schema, "b").execute(p, ctx):
            assert b.torch_device.type == "cuda"
            got += list(zip(*b.to_pydict().values()))
    want = [r for b in batches for r in zip(*b.to_pydict().values())]
    key = lambda r: tuple((x is None, x if x is not None else 0) for x in r)  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key)


# ---------------------------------------------------------------------------
# whole-stage fusion on the card: captured CUDA graphs (plan/fusion.py)
# ---------------------------------------------------------------------------


def _fusion_frames(n_batches: int, rows: int, seed: int, device="cuda"):
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch

    schema = T.Schema((T.Field("k", T.INT64, True), T.Field("v", T.FLOAT64, True),
                       T.Field("q", T.INT32, True)))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        k = rng.integers(0, 5000, rows).astype(np.int64)
        v = rng.integers(-4096, 4096, rows) / 256.0
        q = rng.integers(0, 100, rows).astype(np.int32)
        valid = [np.arange(rows) % 7 != 0, np.arange(rows) % 5 != 0, None]
        out.append(Batch.from_numpy([k, v, q], schema, valid, device=device))
    return schema, out


def _stage_tree(schema, batches, tag: float):
    """filter -> project over the batches; ``tag`` (a literal) keeps each
    test's program key its own in the process-wide graph cache."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.exec.basic import FilterExec, MemoryScanExec, ProjectExec
    from auron_tpu_torch.exprs import ir

    f = FilterExec(MemoryScanExec([list(batches)], schema),
                   [ir.BinaryOp("gt", ir.Column(1, "v"), ir.Literal(tag, T.FLOAT64))])
    return ProjectExec(f, [ir.BinaryOp("add", ir.Column(0, "k"), ir.Literal(1, T.INT64)),
                           ir.BinaryOp("mul", ir.Column(1, "v"), ir.Literal(2.0, T.FLOAT64)),
                           ir.Column(2, "q")], ["k1", "v2", "q"])


def _run_tree(tree, conf: dict, fuse: bool):
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.plan.fusion import fuse_exec_tree
    from auron_tpu_torch.utils.config import Configuration

    c = Configuration(conf)
    if fuse:
        tree = fuse_exec_tree(tree, c, "cuda")
    ctx = ExecutionContext(conf=c, device="cuda")
    out = list(tree.execute(0, ctx))
    torch.cuda.synchronize()
    return tree, out, ctx.metrics.snapshot()["values"]


def _same_batches(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.device.sel, y.device.sel)
        for vx, vy, mx, my in zip(x.device.values, y.device.values, x.device.validity,
                                  y.device.validity):
            assert torch.equal(vx, vy) and torch.equal(mx, my)


@pytest.mark.cuda
def test_captured_stage_replays_equal_eager_on_card():
    """A filter/project stage captured once and replayed for every later
    batch (several capacities) equals its eager run bit for bit; a second
    pass replays only, capturing nothing."""
    from auron_tpu_torch.plan.fusion import FusedStageExec

    _need_card()
    schema, batches = _fusion_frames(6, 1 << 16, 1)
    _, small = _fusion_frames(3, 1000, 2)
    batches = batches[:3] + small + batches[3:]
    tag = -0.390625
    _, eager, _ = _run_tree(_stage_tree(schema, batches, tag), {"exec.fuse.enable": "off",
                                                                "exec.filter.fuse": "false"},
                            False)
    tree, fused, m1 = _run_tree(_stage_tree(schema, batches, tag), {}, True)
    assert isinstance(tree, FusedStageExec)
    _same_batches(fused, eager)
    assert m1["stage_captures"] == 2 and m1["stage_replays"] == len(batches) - 2, m1
    _, again, m2 = _run_tree(_stage_tree(schema, batches, tag), {}, True)
    _same_batches(again, eager)
    assert "stage_captures" not in m2 and m2["stage_replays"] == len(batches), m2


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_held_batches_survive_later_replays_on_card(depth):
    """Batches held downstream (every output of the stream here, and a join's
    transfer window of depth k over a fused probe prologue) keep their rows
    while later batches replay the same graph."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exprs import ir

    _need_card()
    schema, batches = _fusion_frames(8, 1 << 15, 3)
    tag = -1.0 - depth / 8
    _, eager, _ = _run_tree(_stage_tree(schema, batches, tag), {"exec.fuse.enable": "off",
                                                                "exec.filter.fuse": "false"},
                            False)
    _, held, _ = _run_tree(_stage_tree(schema, batches, tag), {}, True)
    _same_batches(held, eager)  # all eight held until the stream ended

    dim_schema = T.Schema((T.Field("id", T.INT64, True), T.Field("w", T.FLOAT64, True)))
    dim = Batch.from_numpy([np.arange(1, 4001, dtype=np.int64), np.arange(4000) * 0.5],
                           dim_schema, device="cuda")

    def join():
        return BroadcastHashJoinExec(_stage_tree(schema, batches, tag),
                                     MemoryScanExec([[dim]], dim_schema),
                                     [ir.Column(0, "k1")], [ir.Column(0, "id")], "inner",
                                     build_side="right")

    conf = {"runtime.transfer.window.depth": str(depth), "join.compact.output": "on"}
    _, want, _ = _run_tree(join(), {**conf, "exec.fuse.enable": "off",
                                    "exec.filter.fuse": "false"}, False)
    _, got, m = _run_tree(join(), conf, True)
    assert m.get("probe_prep_batches", 0) > 0, m
    _same_batches(got, want)


@pytest.mark.cuda
def test_k1_inside_a_captured_shuffle_stage_on_card(tmp_path):
    """A single-int64-key writer stage launches K1 inside its graph: the
    files equal the eager writer's, and K1 counts one launch per batch
    either way (a replay adds its graph's launches)."""
    import os

    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.exprs import ir

    _need_card()
    schema, batches = _fusion_frames(5, 1 << 16, 4)

    def run(conf, fuse, d):
        os.makedirs(d, exist_ok=True)
        w = ShuffleWriterExec(_stage_tree(schema, batches, -2.5),
                              HashPartitioning([ir.Column(0, "k1")], 4),
                              os.path.join(d, "x.data"), os.path.join(d, "x.index"))
        before = pk.LAUNCHES["murmur3_pmod"]
        _, _, m = _run_tree(w, conf, fuse)
        with open(os.path.join(d, "x.data"), "rb") as f:
            data = f.read()
        return data, pk.LAUNCHES["murmur3_pmod"] - before, m

    from auron_tpu_torch.plan.fusion import fusion_stats

    off, k_off, _ = run({"exec.fuse.enable": "off", "exec.filter.fuse": "false"}, False,
                        str(tmp_path / "off"))
    on, k_on, _ = run({}, True, str(tmp_path / "on"))
    captures = fusion_stats()["captures"]
    on2, k_on2, _ = run({}, True, str(tmp_path / "on2"))
    assert on[:-16] == off[:-16] and on2[:-16] == off[:-16]  # the tail is a random tag
    assert k_off == k_on == k_on2 == len(batches), (k_off, k_on, k_on2)
    assert fusion_stats()["captures"] == captures  # the second pass replays only


@pytest.mark.cuda
def test_graph_cache_stays_bounded_over_distinct_builds_on_card():
    """Joins over eight builds of their own (each LUT base differs, so each
    captures its own probe graph) under a memory budget whose graph share
    (a quarter) holds about two graphs: the cached graphs' bytes never pass
    it, the least recently used go, every answer equals the eager join,
    and a spill drops every graph and gives its pool back to the
    allocator."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exprs import ir
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.plan import fusion

    _need_card()
    schema, batches = _fusion_frames(3, 1 << 15, 5)
    dim_schema = T.Schema((T.Field("id", T.INT64, True), T.Field("w", T.FLOAT64, True)))

    def join(base: int):
        dim = Batch.from_numpy([np.arange(base, base + 4000, dtype=np.int64),
                                np.arange(4000) * 0.5], dim_schema, device="cuda")
        return BroadcastHashJoinExec(_stage_tree(schema, batches, -1.75),
                                     MemoryScanExec([[dim]], dim_schema),
                                     [ir.Column(0, "k1")], [ir.Column(0, "id")], "inner",
                                     build_side="right")

    off = {"exec.fuse.enable": "off", "exec.filter.fuse": "false"}
    before = fusion.fusion_stats()
    _, want, _ = _run_tree(join(1), off, False)
    _, got, m = _run_tree(join(1), {}, True)
    _same_batches(got, want)
    assert m.get("probe_prep_batches", 0) > 0, m
    assert fusion.fusion_stats()["captures"] > before["captures"]
    one = fusion.fusion_stats()["pool_bytes"] - before["pool_bytes"]
    assert one > 0
    fusion._GRAPHS.spill()  # earlier tests' graphs would not fit the small budget
    try:
        mm = MemManager.init(budget_bytes=int(2.5 * one * fusion.GRAPH_BUDGET_SHARE / 0.6))
        cap = mm.budget // fusion.GRAPH_BUDGET_SHARE
        evicted = fusion.fusion_stats()["evictions"]
        for base in range(100, 900, 100):
            _, want, _ = _run_tree(join(base), off, False)
            captures = fusion.fusion_stats()["captures"]
            _, got, _ = _run_tree(join(base), {}, True)
            _same_batches(got, want)
            # a build of its own (its LUT base) captures a graph of its own
            assert fusion.fusion_stats()["captures"] > captures
            assert 0 < fusion.fusion_stats()["pool_bytes"] <= cap
            assert mm.total_used() >= fusion.fusion_stats()["pool_bytes"]  # counted
    finally:
        MemManager.init()
    assert fusion.fusion_stats()["evictions"] - evicted >= 6
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    held = fusion.fusion_stats()["pool_bytes"]
    assert fusion._GRAPHS.spill() == held > 0
    assert fusion.fusion_stats()["pool_bytes"] == 0 and not fusion._GRAPHS._graphs
    torch.cuda.empty_cache()  # dropped private pools go back to the device
    assert reserved - torch.cuda.memory_reserved() >= held // 2, (reserved, held)


@pytest.mark.cuda
def test_fused_classes_equal_eager_on_card():
    """q42 (dense prep in the stage program, a fused probe prologue), q93
    (a writer stage with K1) and the probe class (the sorted-state probe and
    merge-path) with this slice's keys on and off: equal answers."""
    from auron_tpu_torch.models import tpcds

    _need_card()
    d = tpcds.generate(0.5, 42)
    off = {"exec.fuse.enable": "off", "exec.filter.fuse": "false",
           "exec.agg.incremental.probe": "off", "exec.agg.incremental.mergepath": "off"}
    for name in ("q42", "q93", "q42_decimal"):
        run = getattr(tpcds, f"run_{name}_class")
        a, b = run(d, device="cuda"), run(d, device="cuda", conf=off)
        want = getattr(tpcds, f"{name}_class_oracle")(d)
        for k in want:
            for got in (a, b):
                g, w = np.asarray(got[k]), np.asarray(want[k])
                if g.dtype.kind == "f":
                    np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)
                else:
                    assert g.tolist() == w.tolist(), (name, k)
    ing = {"probe_fact": tpcds.to_batches(d.store_sales, 1, 1 << 17, "cuda")}
    st: dict = {}
    a = tpcds.run_probe_agg_class(d, device="cuda", ingested=ing, stats=st)
    b = tpcds.run_probe_agg_class(d, device="cuda", conf=off, ingested=ing)
    want = tpcds.probe_agg_class_oracle(d)
    for k in want:
        for got in (a, b):
            if k == "s":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=0)
            else:
                assert np.array_equal(got[k], want[k]), k
    assert st["counters"].get("HashAggExec.probe_hit_rows", 0) > 0, st["counters"]


# ---------------------------------------------------------------------------
# slice 12: the function registry, GenerateExec and xxhash64 on the card
# ---------------------------------------------------------------------------

#: float functions whose CUDA libm result may differ from the CPU's in the
#: last bits: compared at rel 1e-12
_CARD_RTOL_FNS = frozenset({"sqrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan", "asin",
                            "acos", "atan", "sinh", "cosh", "tanh", "cbrt", "pow", "atan2"})


def _function_names():
    """The registry's names but the MAP/STRUCT ones (their cases:
    ``test_nested_function_on_card_equals_cpu``)."""
    import torch_function_cases as C

    from auron_tpu_torch.functions import registry

    return [n for n in registry.names() if n not in C.NESTED_FUNCTIONS]


def _nested_cases():
    import torch_function_cases as C

    return list(C.NESTED_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _nested_cases())
def test_nested_function_on_card_equals_cpu(case):
    """Each MAP/STRUCT function case on the card against the same call on
    the CPU (the vocabularies on the host, the codes and the validity on
    the card); a case that raises on the CPU raises on the card."""
    import torch_function_cases as C

    from auron_tpu_torch.exprs import ir as pir
    from auron_tpu_torch.exprs.eval import Evaluator

    _need_card()
    cpu, card = C.nested_port_batch("cpu"), C.nested_port_batch("cuda")
    e = C.nested_expr(pir, case)
    if case in C.NESTED_RAISES:
        for b in (cpu, card):
            with pytest.raises(ValueError):
                Evaluator(b.schema).evaluate(b, [e])
        return
    want = Evaluator(cpu.schema).evaluate(cpu, [e])[0]
    got = Evaluator(card.schema).evaluate(card, [e])[0]
    assert got.values.device.type == "cuda" and got.dtype == want.dtype, case
    gv, gm, ge = C.host_result(got)
    wv, wm, we = C.host_result(want)
    np.testing.assert_array_equal(gm, wm, err_msg=case)
    if we is not None:
        assert C.decoded(gv, gm, ge) == C.decoded(wv, wm, we), case
    else:
        np.testing.assert_array_equal(gv[gm], wv[wm], err_msg=case)


@pytest.mark.cuda
def test_bloom_filter_defaults_to_the_card():
    """Without a device a new or read filter lands on the card and answers
    as the same filter on the CPU (exact)."""
    from auron_tpu_torch.ops.bloom import SparkBloomFilter

    _need_card()
    items = torch.from_numpy(np.random.default_rng(5).integers(-2**40, 2**40, 2000))
    card = SparkBloomFilter.create(2000, 0.03)
    cpu = SparkBloomFilter.create(2000, 0.03, device="cpu")
    assert card.words.device.type == "cuda"
    card.put_long(items.cuda())
    cpu.put_long(items)
    assert card.serialize() == cpu.serialize()
    back = SparkBloomFilter.deserialize(cpu.serialize())
    assert back.words.device.type == "cuda"
    assert torch.equal(back.might_contain_long(items.cuda()).cpu(), cpu.might_contain_long(items))


@pytest.mark.cuda
@pytest.mark.parametrize("name", _function_names())
def test_registry_function_on_card_equals_cpu(name):
    """Every ported scalar function once on the card (its device kernel or
    its host path with the result put back on the card) against the same
    call on the CPU."""
    import torch_function_cases as C

    from auron_tpu_torch import types as PT
    from auron_tpu_torch.exprs import ir as pir
    from auron_tpu_torch.exprs.eval import Evaluator
    from auron_tpu_torch.ops.bloom import SparkBloomFilter

    _need_card()
    bf = SparkBloomFilter.create(200, 0.05, device="cpu")
    bf.put_long(torch.from_numpy(C.bloom_values()))
    frame = C.host_frame()
    cpu, card = C.port_batch(frame, "cpu"), C.port_batch(frame, "cuda")
    for args in C.cases(pir, PT, bf.serialize())[name]:
        e = pir.ScalarFunc(name, tuple(args))
        want = Evaluator(cpu.schema).evaluate(cpu, [e])[0]
        got = Evaluator(card.schema).evaluate(card, [e])[0]
        assert got.values.device.type == "cuda", name
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        gv, gm, ge = C.host_result(got)
        wv, wm, we = C.host_result(want)
        np.testing.assert_array_equal(gm, wm, err_msg=name)
        if we is not None:
            assert C.decoded(gv, gm, ge) == C.decoded(wv, wm, we), name
        elif gv.dtype.kind == "f":
            g, w = gv[gm], wv[wm]
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            ok = ~np.isnan(w)
            if name in _CARD_RTOL_FNS:
                np.testing.assert_allclose(g[ok], w[ok], rtol=1e-12,
                                           atol=np.finfo(np.float64).tiny, err_msg=name)
            else:
                np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)
        else:
            np.testing.assert_array_equal(gv[gm], wv[wm], err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["explode", "explode_outer", "pos_explode", "pos_explode_outer",
                                 "json_tuple"])
def test_generate_on_card_equals_cpu(gen):
    """GenerateExec on ``cuda`` emits the CPU's rows and chunk capacities
    (over 65,536 rows: two chunks), with one blocking read a batch."""
    import torch_function_cases as C

    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.basic import MemoryScanExec
    from auron_tpu_torch.exec.generate_exec import GenerateExec
    from auron_tpu_torch.exprs import ir as pir

    _need_card()
    rng = np.random.default_rng(21)
    frame = C.host_frame()
    n = 30_000  # ~75,000 exploded rows of li plus the empty and NULL rows
    idx = rng.integers(0, C.N, n)
    big = {k: (([v[i] for i in idx] if isinstance(v, list) else v[idx]), m[idx])
           for k, (v, m) in frame.items()}
    outs = {}
    for dev in ("cpu", "cuda"):
        b = C.port_batch(big, dev)
        scan = MemoryScanExec([[b, C.port_batch(frame, dev)]], b.schema)
        if gen == "json_tuple":
            op = GenerateExec(scan, "json_tuple", pir.col(C.COL["js"]), [0],
                              json_fields=["a", "b", "c"])
        else:
            op = GenerateExec(scan, gen.replace("_outer", ""), pir.col(C.COL["li"]),
                              [0, C.COL["s"]], outer=gen.endswith("outer"))
        ctx = ExecutionContext(device=dev)
        batches = list(op.execute(0, ctx))
        outs[dev] = ([x.capacity for x in batches], collect_rows(batches), ctx.metrics.values)
    assert outs["cuda"][:2] == outs["cpu"][:2]
    if gen != "json_tuple":
        assert outs["cuda"][2]["blocking_reads"] == 2
        assert outs["cuda"][0][0] == 1 << 16


def collect_rows(batches) -> list:
    out = []
    for b in batches:
        out.extend(zip(*b.to_pydict().values()))
    return out


@pytest.mark.cuda
def test_hash_batch_xxhash64_on_card_equals_cpu():
    import torch_function_cases as C

    from auron_tpu_torch.ops.hash_dispatch import hash_batch

    _need_card()
    frame = C.host_frame()
    cols = [C.COL[k] for k in ("i32", "i64", "f64", "f32", "s", "d", "ts", "dec", "b", "num")]
    cpu, card = C.port_batch(frame, "cpu"), C.port_batch(frame, "cuda")
    for algo in ("xxhash64", "murmur3"):
        got = hash_batch(card, cols, algo, seed=42)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), hash_batch(cpu, cols, algo).numpy())
    long = C.port_batch({**frame, "s": (["x" * (i % 97) for i in range(C.N)], frame["s"][1])},
                        "cuda")
    np.testing.assert_array_equal(
        hash_batch(long, [C.COL["s"]], "xxhash64").cpu().numpy(),
        hash_batch(C.port_batch({**frame, "s": (["x" * (i % 97) for i in range(C.N)],
                                                frame["s"][1])}, "cpu"),
                   [C.COL["s"]], "xxhash64").numpy())


# ---------------------------------------------------------------------------
# the host boundary on the card (no pyarrow: the port's own producer)
# ---------------------------------------------------------------------------


def _boundary_columns(n: int = 1024, seed: int = 5) -> dict:
    """name -> (type, host column, validity): one per type of the port's
    Arrow format list, made by the port's producer (``HostBatch.from_numpy``
    and raw ``HostArray``s for the unsigned and dictionary formats)."""
    import decimal

    from auron_tpu_torch import types as PT

    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    dec = rng.integers(-10**12, 10**12, n)
    return {
        "i8": (PT.INT8, rng.integers(-128, 127, n).astype(np.int8), valid),
        "i16": (PT.INT16, rng.integers(-2**15, 2**15, n).astype(np.int16), valid),
        "i32": (PT.INT32, rng.integers(-2**31, 2**31, n).astype(np.int32), None),
        "i64": (PT.INT64, rng.integers(-2**62, 2**62, n), valid),
        "f32": (PT.FLOAT32, rng.normal(size=n).astype(np.float32), valid),
        "f64": (PT.FLOAT64, rng.normal(size=n), None),
        "b": (PT.BOOL, rng.random(n) < 0.5, valid),
        "d": (PT.DATE32, rng.integers(-10**5, 10**5, n).astype(np.int32), valid),
        "ts": (PT.TIMESTAMP, rng.integers(-10**15, 10**15, n), valid),
        "dec64": (PT.decimal(18, 2), dec, valid),
        "dec128": (PT.decimal(38, 4), np.array([decimal.Decimal(int(x) * 10**15).scaleb(-4)
                                                for x in dec], dtype=object), valid),
        "s": (PT.STRING, np.array([f"v{x % 13}é" for x in dec], dtype=object), valid),
        "bin": (PT.BINARY, np.array([bytes([x % 7]) for x in dec], dtype=object), None),
        "lst": (PT.DataType(PT.TypeKind.LIST, inner=(PT.INT64,)),
                [[int(y) for y in range(x % 4)] for x in dec], valid),
        "nul": (PT.NULL, np.zeros(n, np.int8), np.zeros(n, bool)),
    }


def _boundary_batch(name: str):
    from auron_tpu_torch import types as PT
    from auron_tpu_torch.columnar import arrow_c

    dtype, col, valid = _boundary_columns()[name]
    schema = PT.Schema((PT.Field(name, dtype),))
    return arrow_c.HostBatch.from_numpy([col], schema, [valid])


def _extra_formats():
    """Unsigned and dictionary-encoded arrays (formats the port reads but does
    not write), built as raw host arrays."""
    from auron_tpu_torch import types as PT
    from auron_tpu_torch.columnar import arrow_c

    n = 1024
    rng = np.random.default_rng(6)
    out = {}
    for fmt, npdt, dtype in (("C", np.uint8, PT.INT16), ("S", np.uint16, PT.INT32),
                             ("I", np.uint32, PT.INT64), ("L", np.uint64, PT.INT64)):
        vals = rng.integers(0, np.iinfo(npdt).max // 2, n).astype(npdt)
        arr = arrow_c.HostArray(fmt, dtype, n, 0, 0, (None, vals.view(np.uint8)))
        out[fmt] = arrow_c.HostBatch(PT.Schema((PT.Field(fmt, dtype),)), n, (arr,))
    codes = rng.integers(0, 3, n).astype(np.int8)
    valid = rng.random(n) > 0.3
    arr = arrow_c.HostArray("c", PT.STRING, n, int((~valid).sum()), 0,
                            (np.packbits(valid, bitorder="little"), codes.view(np.uint8)), (),
                            arrow_c.array_from_pylist(["x", "yy", "zzz"], PT.STRING))
    out["dict"] = arrow_c.HostBatch(PT.Schema((PT.Field("dict", PT.STRING),)), n, (arr,))
    return out


_BOUNDARY = ["i8", "i16", "i32", "i64", "f32", "f64", "b", "d", "ts", "dec64", "dec128", "s",
             "bin", "lst", "nul", "C", "S", "I", "L", "dict"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _BOUNDARY)
def test_host_arrow_ingest_on_card_equals_cpu(name):
    """The port's C stream producer, its importer, then a ``cuda`` batch:
    equal to the CPU ingest of the same imported arrays (values, validity,
    selection, vocabularies), whole, sliced at an odd offset, with the
    zero-copy key on and off; ``to_host_arrow`` from the card gives the rows
    back."""
    _need_card()
    from auron_tpu_torch.columnar import arrow_c
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.utils.config import Configuration

    extra = name in ("C", "S", "I", "L", "dict")
    hb = _extra_formats()[name] if extra else _boundary_batch(name)
    for part in (hb, hb.slice(13, 700)):
        (imported,) = list(arrow_c.stream_of([part]))
        cpu = Batch.from_host_arrow(imported, device="cpu")
        for zc in ("on", "off"):
            card = Batch.from_host_arrow(imported, device="cuda",
                                         conf=Configuration({"exec.scan.zerocopy": zc}))
            assert card.torch_device.type == "cuda"
            assert torch.equal(card.device.sel.cpu(), cpu.device.sel)
            assert torch.equal(card.device.validity[0].cpu(), cpu.device.validity[0])
            assert torch.equal(card.device.values[0].cpu(), cpu.device.values[0])
            assert (card.dicts[0] is None) == (cpu.dicts[0] is None)
            if cpu.dicts[0] is not None:
                assert list(card.dicts[0]) == list(cpu.dicts[0])
            assert card.to_host_arrow().to_pydict() == cpu.to_host_arrow().to_pydict()
        if not extra:  # the others come back in the port's canonical formats
            assert cpu.to_host_arrow().to_pydict() == part.to_pydict()


@pytest.mark.cuda
def test_ffi_reader_of_a_cuda_task_refuses_cpu_batches():
    _need_card()
    from auron_tpu_torch import types as PT
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.scan import FFIReaderExec

    schema = PT.Schema((PT.Field("x", PT.INT64),))
    b = Batch.from_numpy([np.arange(5)], schema, device="cpu")
    op = FFIReaderExec(schema, "src")
    ctx = ExecutionContext(device="cuda", resources={"src": [b]})
    with pytest.raises(RuntimeError, match="yielded a batch on cpu"):
        list(op.execute(0, ctx))


@pytest.mark.cuda
def test_bridge_queries_on_card_equal_their_oracles():
    """q42 and q93 through the host boundary on cuda (C streams in, IPC
    blocks and C arrays out) equal their numpy oracles; q93's map tasks
    launch K1 as the device runner's do; the zero-copy key moves planes
    between the two counters and nothing else."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    # 144,000 fact rows in batches of 65,536: two full, one padded
    host42, host93 = tpcds.host_q42(data, batch_rows=1 << 16), tpcds.host_q93(data, 4)
    for zc, zero_copy in (("on", 18), ("off", 0)):
        st: dict = {}
        got = tpcds.run_q42_bridge(device="cuda", conf={"exec.scan.zerocopy": zc},
                                   host=host42, stats=st)
        want = tpcds.q42_class_oracle(data)
        np.testing.assert_array_equal(got["brand"], want["brand"])
        np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
        # 3 x 5 fact planes and 5 item planes; with the key on every one
        # but the item's two strings (encoded on the host) is a view
        assert st["zerocopy_planes"] + st["copied_planes"] == 20
        assert st["zerocopy_planes"] == zero_copy
    before = pk.LAUNCHES["murmur3_pmod"]
    got = tpcds.run_q93_bridge(device="cuda", host=host93)
    assert pk.LAUNCHES["murmur3_pmod"] - before == 4
    want = tpcds.q93_class_oracle(data)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_q42_from_task_bytes_on_card_without_protobuf():
    """q42 from its TaskDefinition bytes (``run_q42_class``: the port's own
    builders encode the plan, its codec decodes it in ``call_native``) on
    cuda equals its oracle, launches K3 once (SF 0.1 has SF 8's 18,000
    items: the top-10 sort is 16,384 x 8), and no google.protobuf is
    loaded."""
    _need_card()
    import sys

    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.1, 42)
    ingested = tpcds.ingest_q42(data, device="cuda")
    before = dict(pb.LAUNCHES)
    st: dict = {}
    got = tpcds.run_q42_class(device="cuda", ingested=ingested, stats=st)
    assert pb.LAUNCHES["bitonic_sort"] - before["bitonic_sort"] == 1
    want = tpcds.q42_class_oracle(data)
    np.testing.assert_array_equal(got["brand"], want["brand"])
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
    assert st["task_bytes"] > 0 and st["decode_s"] > 0 and st["plan_s"] > 0
    assert not [m for m in sys.modules if m.startswith("google.protobuf")]


@pytest.mark.cuda
def test_range_partition_ids_on_card_equal_cpu():
    """``RangePartitioning.partition_ids`` on the card equals its CPU run on
    the same seeded batch (int64 and float64 keys with NULLs, NaN and
    signed zeros; both directions, both NULL placements)."""
    _need_card()
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.shuffle.partitioning import RangePartitioning, make_range_bounds
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.ops.sortkeys import SortSpec

    rng = np.random.default_rng(7)
    n = 100_003
    a = rng.integers(-500, 500, n)
    f = np.where(rng.random(n) < 0.1, rng.choice([np.nan, -0.0, 0.0], n), rng.normal(0, 9, n))
    schema = T.Schema((T.Field("a", T.INT64, True), T.Field("f", T.FLOAT64, True)))
    valid = [rng.random(n) > 0.1, rng.random(n) > 0.1]
    specs = [SortSpec(asc=False, nulls_first=False), SortSpec(asc=True, nulls_first=True)]
    cpu = Batch.from_numpy([a, f], schema, valid, device="cpu")
    card = Batch.from_numpy([a, f], schema, valid, device="cuda")
    bounds = make_range_bounds(cpu, [col(0), col(1)], specs, 7)
    assert np.array_equal(bounds, make_range_bounds(card, [col(0), col(1)], specs, 7))
    part = RangePartitioning([col(0), col(1)], specs, 7, bounds)
    want = part.partition_ids(cpu, None)
    got = part.partition_ids(card, None)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert len(np.unique(want.numpy()[:n])) == 7


@pytest.mark.cuda
def test_converted_q42_on_card_equals_its_oracle():
    """q42 from its host-plan JSON through ``convert_plan_json`` and the
    response's one stage on cuda (SF 0.02) equals its oracle."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.02, 42)
    st: dict = {}
    got = tpcds.run_q42_converted(data, device="cuda", stats=st)
    want = tpcds.q42_class_oracle(data)
    np.testing.assert_array_equal(got["brand"], want["brand"])
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
    assert st["stages"] == 1 and st["convert_s"] > 0 and st["response_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("late", ["true", "false"])
def test_parquet_scan_on_card_equals_the_cpu_scan(tmp_path, late):
    """A ``cuda`` task's Parquet scan yields batches on the card, equal to
    the same scan on the CPU (statistics pruning and late materialization
    on a pushed predicate)."""
    _need_card()
    import pyarrow as pa
    import pyarrow.parquet as pq

    from auron_tpu_torch import types as T
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.scan import ParquetScanExec
    from auron_tpu_torch.exprs.ir import BinaryOp, col, lit

    rng = np.random.default_rng(3)
    n = 20_000
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                             "s": pa.array([None if i % 13 == 0 else f"s{i % 40}"
                                            for i in range(n)]),
                             "f": pa.array(rng.normal(size=n))}), path, row_group_size=4096)
    schema = T.Schema((T.Field("k", T.INT64, True), T.Field("s", T.STRING, True),
                       T.Field("f", T.FLOAT64, True)))
    out = {}
    for dev in ("cpu", "cuda"):
        ctx = ExecutionContext(device=dev)
        ctx.conf.set("parquet.late.materialization", late)
        op = ParquetScanExec(schema, [path], [BinaryOp("gteq", col(0), lit(9000))])
        batches = list(op.execute(0, ctx))
        assert all(b.torch_device.type == dev for b in batches)
        out[dev] = ([r for b in batches for r in b.to_arrow().to_pylist()],
                    ctx.metrics.snapshot()["values"]["row_groups_pruned"])
    assert out["cuda"] == out["cpu"] and out["cpu"][1] == 2 and len(out["cpu"][0]) == n - 9000


@pytest.mark.cuda
def test_basket_class_on_card_equals_its_oracle_and_launches_k1_and_k3():
    """The customer-basket class (collect_set, collect_list, named_struct,
    map_from_arrays; LIST states through the file shuffle) on cuda at SF
    0.05 equals its numpy oracle and its CPU run; the map tasks launch K1
    (once a map task: its one state batch) and the reduce tasks'
    SortExecs K3 as ``sort_plan`` lists for the sorts they ran."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    ingested = tpcds.ingest_q3(data, 4, device="cuda")
    want = tpcds.basket_class_oracle(data)
    tpcds.run_basket_class(device="cuda", ingested=ingested)  # warm-up
    shapes: list = []
    before = {**pb.LAUNCHES, **pk.LAUNCHES}
    with _recording_kernel_shapes(shapes):
        got = tpcds.run_basket_class(device="cuda", ingested=ingested).to_pydict()
    launched = {k: v - before[k] for k, v in {**pb.LAUNCHES, **pk.LAUNCHES}.items()}
    assert tpcds.basket_mismatch(got, want) is None
    cpu = tpcds.run_basket_class(data, device="cpu").to_pydict()
    assert tpcds.basket_mismatch(cpu, want) is None and cpu["profile"] == got["profile"]
    assert launched["murmur3_pmod"] == 4  # one state batch a map task
    # each reduce task's SortExec (~19,000 groups: 32,768 slots); the
    # final task's 400-row top is below the kernel's 2,048-slot threshold
    assert len(shapes) == launched["bitonic_sort"] == 4
    planned = {k: sum(pb.sort_plan(*s).launch_counts()[k] for s in shapes) for k in pb.LAUNCHES}
    assert {k: launched[k] for k in pb.LAUNCHES} == planned


@pytest.mark.cuda
def test_q93_and_q72_on_slots_on_card_equal_sequential_with_the_same_k1():
    """q93 and q72 with their map and reduce tasks on 4 slots, each a CUDA
    stream of its own, equal their sequential runs and their oracles, and
    launch K1 as often (q93: one fact batch a map task at SF 0.1)."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.1, 42)
    fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
    for name, ing in (("q93", tpcds.ingest_q93(data, 4, device="cuda", fact=fact)),
                      ("q72", tpcds.ingest_q72(data, 4, device="cuda", fact=fact))):
        run = getattr(tpcds, f"run_{name}_class")
        want = getattr(tpcds, f"{name}_class_oracle")(data)
        got = {}
        for parallel in (False, True, False, True):
            before = pk.LAUNCHES["murmur3_pmod"]
            ans = run(device="cuda", ingested=ing, parallel=parallel)
            got.setdefault(parallel, []).append((ans, pk.LAUNCHES["murmur3_pmod"] - before))
        for runs in got.values():
            for ans, k1 in runs:
                assert k1 == got[False][0][1] > 0, (name, k1)
                for k, w in want.items():
                    if np.asarray(w).dtype.kind == "f":
                        np.testing.assert_allclose(ans[k], w, rtol=1e-9, atol=0)
                    else:
                        np.testing.assert_array_equal(ans[k], w)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lz4", "zstd", "encoding off", "rss"])
def test_q93_shuffle_variants_on_card_equal_the_oracle(variant):
    """q93's shuffle at the reference's default codec (lz4), zstd, v1 blocks
    and through the remote shuffle service over TCP equals its oracle and
    launches K1 as the default run does."""
    _need_card()
    from auron_tpu_torch.exec.shuffle import format as pf
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.1, 42)
    ing = tpcds.ingest_q93(data, 4, device="cuda")
    conf = {"zstd": {"exec.shuffle.encoding.fallback.codec": "zstd"},
            "encoding off": {"exec.shuffle.encoding": "off"}}.get(variant)
    pf._codec_warned.clear()
    before = pk.LAUNCHES["murmur3_pmod"]
    st: dict = {}
    got = tpcds.run_q93_class(device="cuda", ingested=ing, conf=conf, stats=st,
                              transport="rss" if variant == "rss" else "file")
    assert pk.LAUNCHES["murmur3_pmod"] - before == 4
    want = tpcds.q93_class_oracle(data)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    assert not pf._codec_warned
    if variant == "rss":
        assert st["timers"]["RssShuffleWriterExec.push_time"] > 0


@pytest.mark.cuda
def test_udf_class_on_card_equals_its_oracle():
    """The host-callback class on cuda (a UDF in q42's converted plan, a Hive
    UDF through the C callback, the UDAF over a file shuffle of pickled
    states, the UDTF) equals its oracle; q42's top sort launches K3 as
    ``sort_plan`` lists."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.1, 42)
    ing = tpcds.ingest_q3(data, 4, device="cuda")
    shapes: list = []
    before = dict(pb.LAUNCHES)
    with _recording_kernel_shapes(shapes):
        got = tpcds.run_udf_class(device="cuda", ingested=ing, install="api")
    assert tpcds.udf_mismatch(got, tpcds.udf_class_oracle(data)) is None
    launched = {k: pb.LAUNCHES[k] - before[k] for k in pb.LAUNCHES}
    planned = {k: sum(pb.sort_plan(*s).launch_counts()[k] for s in shapes) for k in pb.LAUNCHES}
    assert shapes and launched == planned
