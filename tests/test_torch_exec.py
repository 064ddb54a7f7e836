"""Module parity of auron_tpu_torch against auron_tpu on the CPU: types,
batches, segmentation, hash aggregation (dense and sort-segmentation
paths), broadcast hash join and SortExec. Each test feeds the same batch
content to both packages (the port's batches carry the reference batches'
host planes, tests/torch_carry.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.columnar import batch as jbatch
from auron_tpu.exec import agg_exec as jagg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.joins import BroadcastHashJoinExec as JBHJ
from auron_tpu.exec.sort_exec import SortExec as JSort
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import ColumnVal as JCV
from auron_tpu.ops import segments as jseg
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as PT
from auron_tpu_torch.columnar import batch as pbatch
from auron_tpu_torch.exec import agg_exec as pagg
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exec.sort_exec import SortExec as PSort
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import ColumnVal as PCV
from auron_tpu_torch.ops import segments as pseg
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, port_schema, rows


# ---------------------------------------------------------------------------
# types and batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [k for k in JT.TypeKind
                                  if k not in (JT.TypeKind.UNSUPPORTED, JT.TypeKind.LIST,
                                               JT.TypeKind.MAP, JT.TypeKind.STRUCT)])
def test_physical_dtypes_match(kind):
    jt = JT.DataType(kind, 10, 2) if kind == JT.TypeKind.DECIMAL else JT.DataType(kind)
    pt = PT.DataType(PT.TypeKind(kind.value), jt.precision, jt.scale)
    assert str(pt.physical_dtype()).replace("torch.", "") == jt.physical_dtype().name
    assert pt.is_dict_encoded == jt.is_dict_encoded and repr(pt) == repr(jt)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "big": rng.integers(-(2**40), 2**40, n).astype(np.int64),
        "x": np.round(rng.gamma(2.0, 10.0, n), 2),
        "q": rng.integers(1, 100, n).astype(np.int32),
        "s": rng.choice(np.array(["a", "bb", "ccc", "dd"], dtype=object), n),
    }
    valid = {"k": rng.random(n) > 0.1, "x": rng.random(n) > 0.05, "s": rng.random(n) > 0.2}
    return cols, valid


def test_from_numpy_matches_reference_planes():
    cols, valid = _table(300, 1)
    jb = jax_batch(cols, valid)
    pbx = pbatch.Batch.from_numpy(list(cols.values()), port_schema(jb.schema),
                                  [valid.get(c) for c in cols], device="cpu")
    ref = carry(jb)
    assert pbx.schema == ref.schema and pbx.capacity == ref.capacity == 512
    assert torch.equal(pbx.device.sel, ref.device.sel)
    for i in range(len(cols)):
        assert torch.equal(pbx.device.validity[i], ref.device.validity[i])
        assert torch.equal(pbx.device.values[i], ref.device.values[i])
        if ref.dicts[i] is not None:
            assert list(pbx.dicts[i]) == list(ref.dicts[i])
    assert rows([pbx]) == rows([jb])


def test_device_concat_and_compaction_match_reference():
    parts = [_table(n, s) for n, s in ((200, 2), (130, 3), (90, 4))]
    jbs = [jax_batch(c, v) for c, v in parts]
    want = jbatch.device_concat(jbs)
    got = pbatch.device_concat([carry(b) for b in jbs])
    ref = carry(want)
    assert got.capacity == ref.capacity
    assert torch.equal(got.device.sel, ref.device.sel)
    for i in range(len(ref.schema)):
        assert torch.equal(got.device.validity[i], ref.device.validity[i])
        assert torch.equal(torch.where(ref.device.validity[i], got.device.values[i], 0),
                           torch.where(ref.device.validity[i], ref.device.values[i], 0))
    assert rows([got]) == rows([want])
    assert pbatch.bucket_capacity(1000) == jbatch.bucket_capacity(1000)
    assert pbatch.compaction_bucket(100, 4096) == jbatch.compaction_bucket(100, 4096)
    assert rows([pbatch.compact_batch(got, 512)]) == rows([want])


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract is exercised elsewhere")
    cols, valid = _table(10, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        pbatch.Batch.from_numpy(list(cols.values()), port_schema(jax_batch(cols).schema))


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lax", "jnp", "fingerprint", "fingerprint_bits4"])
def test_segment_by_keys_matches_reference(mode):
    rng = np.random.default_rng(11)
    cap = 2048
    v1 = rng.integers(-30, 30, cap).astype(np.int64)
    v2 = rng.integers(0, 3, cap).astype(np.int32)
    m1, m2 = rng.random(cap) > 0.1, rng.random(cap) > 0.05
    sel = rng.random(cap) > 0.2
    jwords = jseg.key_words([JCV(jnp.asarray(v1), jnp.asarray(m1), JT.INT64),
                             JCV(jnp.asarray(v2), jnp.asarray(m2), JT.INT32)])
    pwords = pseg.key_words([PCV(torch.from_numpy(v1), torch.from_numpy(m1), PT.INT64),
                             PCV(torch.from_numpy(v2), torch.from_numpy(m2), PT.INT32)])
    fp = mode.startswith("fingerprint")
    bits = 4 if mode == "fingerprint_bits4" else 64
    impl = "lax" if fp else mode
    want = jseg.segment_by_keys(jwords, jnp.asarray(sel), host_sort=False, device_impl=impl,
                                n_key_cols=2, fingerprint=fp, fp_bits=bits)
    got = pseg.segment_by_keys(pwords, torch.from_numpy(sel), device_impl=impl,
                               n_key_cols=2, fingerprint=fp, fp_bits=bits)
    ng = int(want.num_groups)
    assert int(got.num_groups) == ng
    for f in ("order", "seg_ids", "boundary", "sel_sorted"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.group_of_slot.numpy()[:ng],
                                  np.asarray(want.group_of_slot)[:ng])
    if fp:
        assert bool(got.collision) == bool(want.collision)
        if bits == 4:
            assert bool(got.collision)


# ---------------------------------------------------------------------------
# hash aggregation
# ---------------------------------------------------------------------------


def _batches(seed, n_batches=3, n=700, key_range=40, key_dtype=np.int32):
    out = []
    for i in range(n_batches):
        cols, valid = _table(n, seed + i)
        rng = np.random.default_rng(seed + 100 + i)
        cols["k"] = rng.integers(0, key_range, n).astype(key_dtype)
        out.append(jax_batch(cols, valid))
    return out


def _run_agg(mod_scan, mod_agg, exprs_mod, batches, key_col, aggs, ctx):
    col = exprs_mod.col
    scan = mod_scan([batches], batches[0].schema)
    groupings = [(col(key_col), "g")]
    specs = [(mod_agg.AggExpr(f, None if c is None else col(c)), f"a{i}")
             for i, (f, c) in enumerate(aggs)]
    p = mod_agg.HashAggExec(scan, groupings, specs, "partial")
    merged = [(mod_agg.AggExpr(f, None if c is None else col(c)), f"a{i}")
              for i, (f, c) in enumerate(aggs)]
    f = mod_agg.HashAggExec(p, [(col(0), "g")], merged, "final")
    return list(f.execute(0, ctx))


_AGGS = [("sum", 2), ("count", 2), ("count_star", None), ("avg", 3), ("min", 1), ("max", 2),
         ("sum", 3)]


def _compare_agg_rows(got, want):
    g, w = canon(rows(got)), canon(rows(want))
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12)
            else:
                assert a == b


@pytest.mark.parametrize("path", ["dense", "fingerprint", "fullword_lax", "fullword_bitonic"])
@pytest.mark.parametrize("key_col", [0, 1])
def test_hash_agg_matches_reference(path, key_col):
    big_keys = path != "dense"
    jbs = _batches(20 + key_col, key_range=(2**40 if big_keys else 40),
                   key_dtype=np.int64 if big_keys else np.int32)
    conf = {
        "dense": {},
        "fingerprint": {"exec.agg.incremental.fingerprint": "on"},
        "fullword_lax": {"exec.agg.incremental.fingerprint": "off"},
        "fullword_bitonic": {"exec.agg.incremental.fingerprint": "off",
                             "exec.device.sort.impl": "pallas"},
    }[path]
    kc = 0 if key_col == 0 else 1  # group by k, or by the wide 'big' column
    want = _run_agg(JScan, jagg, jir, jbs, kc, _AGGS, JCtx())
    got = _run_agg(PScan, pagg, pir, [carry(b) for b in jbs], kc, _AGGS,
                   PCtx(conf=PConf(conf), device="cpu"))
    _compare_agg_rows(got, want)


def test_hash_agg_global_and_empty_match_reference():
    jbs = _batches(40)
    want = _run_agg(JScan, jagg, jir, jbs, 0, _AGGS, JCtx())
    got = _run_agg(PScan, pagg, pir, [carry(b) for b in jbs], 0, _AGGS,
                   PCtx(device="cpu"))
    _compare_agg_rows(got, want)
    # global aggregate over batches with no live rows: one row, count 0
    empty = pbatch.Batch.empty(port_schema(jbs[0].schema), device="cpu")
    scan = PScan([[empty]], empty.schema)
    specs = [(pagg.AggExpr("count_star"), "n"), (pagg.AggExpr("sum", pir.col(2)), "s")]
    p = pagg.HashAggExec(scan, [], specs, "partial")
    f = pagg.HashAggExec(p, [], specs, "final")
    assert rows(list(f.execute(0, PCtx(device="cpu")))) == [(0, None)]


def test_hash_agg_dense_reanchor_and_fallback():
    """Key ranges that drift (re-anchor) and then explode (fallback to the
    sort path) still give the reference's groups."""
    jbs = []
    for i, (lo, hi) in enumerate(((0, 50), (1000, 1100), (0, 2**40))):
        cols, valid = _table(600, 60 + i)
        cols["big"] = np.random.default_rng(i).integers(lo, hi, 600).astype(np.int64)
        jbs.append(jax_batch(cols, valid))
    want = _run_agg(JScan, jagg, jir, jbs, 1, _AGGS, JCtx())
    got = _run_agg(PScan, pagg, pir, [carry(b) for b in jbs], 1, _AGGS, PCtx(device="cpu"))
    _compare_agg_rows(got, want)


# ---------------------------------------------------------------------------
# broadcast hash join
# ---------------------------------------------------------------------------


def _dim(n, seed, keys):
    rng = np.random.default_rng(seed)
    return jax_batch({"dk": keys.astype(np.int64),
                      "attr": rng.integers(0, 1000, n).astype(np.int32),
                      "w": rng.random(n)},
                     {"attr": rng.random(n) > 0.1})


@pytest.mark.parametrize("case", ["lut", "sorted_unique", "duplicates", "build_left"])
@pytest.mark.parametrize("projection", [None, [4, 6, 1]])
def test_bhj_matches_reference(case, projection):
    rng = np.random.default_rng(77)
    nd = 300
    if case == "lut":
        dkeys = rng.permutation(nd) + 5
    elif case == "sorted_unique":
        dkeys = rng.choice(2**45, nd, replace=False) - 2**44
    else:
        dkeys = rng.integers(0, 120, nd)
    dim = _dim(nd, 3, dkeys)
    facts = []
    for i in range(3):
        cols, valid = _table(500, 90 + i)
        pool = dkeys if i < 2 else np.arange(-50, 50)  # last batch: mostly misses
        cols["big"] = rng.choice(pool, 500).astype(np.int64)
        valid["big"] = rng.random(500) > 0.1  # NULL keys never match
        facts.append(jax_batch(cols, valid))
    build_side = "left" if case == "build_left" else "right"
    if build_side == "left":
        lk, rk = [0], [1]
        proj = None if projection is None else [3 + 4, 0, 1]
        mk = lambda S, H, ir, d, f: H(S([d], d[0].schema), S([f], f[0].schema),
                                       [ir.col(0)], [ir.col(1)], "inner", build_side="left",
                                       projection=proj)
    else:
        proj = projection
        mk = lambda S, H, ir, d, f: H(S([f], f[0].schema), S([d], d[0].schema),
                                       [ir.col(1)], [ir.col(0)], "inner", build_side="right",
                                       projection=proj)
    want = list(mk(JScan, JBHJ, jir, [dim], facts).execute(0, JCtx()))
    got = list(mk(PScan, PBHJ, pir, [carry(dim)], [carry(b) for b in facts])
               .execute(0, PCtx(device="cpu")))
    assert canon(rows(got)) == canon(rows(want))
    assert len(rows(got)) > 0


# ---------------------------------------------------------------------------
# SortExec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["lax", "pallas"])
@pytest.mark.parametrize("fetch", [None, 10, 700])
def test_sort_exec_matches_reference(impl, fetch):
    jbs = _batches(50, n_batches=2, n=600)
    keys = [(2, (False, True)), (0, (True, False)), (4, (True, True)), (1, (True, True))]

    def build(S, Sort, ir, Spec, batches):
        return Sort(S([batches], batches[0].schema), [ir.col(c) for c, _ in keys],
                    [Spec(asc=a, nulls_first=nf) for _, (a, nf) in keys], fetch=fetch)

    want = rows(list(build(JScan, JSort, jir, JSpec, jbs).execute(0, JCtx())))
    got = rows(list(build(PScan, PSort, pir, PSpec, [carry(b) for b in jbs])
                    .execute(0, PCtx(conf=PConf({"exec.device.sort.impl": impl}),
                                     device="cpu"))))
    assert got == want
    assert len(got) == (fetch if fetch is not None else 1200)


@pytest.mark.parametrize("op", ["sort", "agg"])
def test_host_sort_key_parses_and_changes_nothing(op):
    """``exec.host.sort=on`` is accepted for conf parity with the host
    engine and sorts where the tensors live all the same: the port's rows
    equal the reference run with the same conf."""
    conf = {"exec.host.sort": "on", "exec.agg.incremental.fingerprint": "off",
            "exec.device.sort.impl": "pallas"}
    jbs = _batches(70, n_batches=2, n=500, key_range=2**40, key_dtype=np.int64)
    pbs = [carry(b) for b in jbs]
    pctx = PCtx(conf=PConf(conf), device="cpu")
    if op == "agg":
        want = _run_agg(JScan, jagg, jir, jbs, 0, _AGGS, JCtx(conf=JConf(conf)))
        _compare_agg_rows(_run_agg(PScan, pagg, pir, pbs, 0, _AGGS, pctx), want)
        return
    specs = [(0, (True, False)), (2, (False, True))]
    want = rows(list(JSort(JScan([jbs], jbs[0].schema), [jir.col(c) for c, _ in specs],
                           [JSpec(asc=a, nulls_first=nf) for _, (a, nf) in specs],
                           fetch=10).execute(0, JCtx(conf=JConf(conf)))))
    got = rows(list(PSort(PScan([pbs], pbs[0].schema), [pir.col(c) for c, _ in specs],
                          [PSpec(asc=a, nulls_first=nf) for _, (a, nf) in specs],
                          fetch=10).execute(0, pctx)))
    assert got == want and len(got) == 10


# ---------------------------------------------------------------------------
# expressions, stateless operators, Arrow interop
# ---------------------------------------------------------------------------


def _expr_cases(ir, T):
    c, lit = ir.col, ir.lit
    B = ir.BinaryOp
    return [
        B("add", c(0), c(3)), B("sub", c(1), lit(7)), B("mul", c(2), lit(2.5)),
        B("div", c(0), c(3)), B("div", c(2), B("sub", c(3), c(3))),
        B("mod", c(1), lit(7)), B("mod", c(2), lit(0.0)), B("mod", c(0), B("sub", c(3), c(3))),
        B("lt", c(0), c(3)), B("gteq", c(2), lit(20.0)), B("eq", c(4), lit("bb")),
        B("neq", c(4), c(4)), B("lt", c(4), lit("c")),
        B("and", B("lt", c(0), lit(20)), B("gt", c(2), lit(15.0))),
        B("or", B("lt", c(0), lit(5)), B("gt", c(2), lit(30.0))),
        ir.Cast(c(2), T.INT32), ir.Cast(c(0), T.FLOAT64), ir.Cast(c(1), T.INT32),
        ir.Cast(B("mul", c(2), lit(1e12)), T.INT64), ir.Not(B("lt", c(0), lit(20))),
        ir.IsNull(c(4)), ir.IsNotNull(c(2)),
    ]


def test_evaluator_matches_reference():
    from auron_tpu.exprs.eval import Evaluator as JEval
    from auron_tpu_torch.exprs.eval import Evaluator as PEval

    cols, valid = _table(400, 31)
    jb = jax_batch(cols, valid)
    pbx = carry(jb)
    want = JEval(jb.schema, partition_id=0, resources={}).evaluate(jb, _expr_cases(jir, JT))
    got = PEval(pbx.schema).evaluate(pbx, _expr_cases(pir, PT))
    for i, (w, g) in enumerate(zip(want, got)):
        assert repr(g.dtype) == repr(w.dtype), i
        wm = np.asarray(w.validity)
        np.testing.assert_array_equal(g.validity.numpy(), wm, err_msg=str(i))
        np.testing.assert_array_equal(g.values.numpy()[wm], np.asarray(w.values)[wm],
                                      err_msg=str(i))


def test_filter_project_limit_match_reference():
    from auron_tpu.exec.basic import FilterExec as JF, LimitExec as JL, ProjectExec as JP
    from auron_tpu_torch.exec.basic import FilterExec as PF, LimitExec as PL, ProjectExec as PP

    jbs = _batches(70, n_batches=3, n=500)

    def build(S, F, P, L, ir, batches):
        c, B = ir.col, ir.BinaryOp
        f = F(S([batches], batches[0].schema),
              [B("gt", c(2), ir.lit(12.0)), B("lt", c(0), ir.lit(30))])
        p = P(f, [B("mul", c(2), c(3)), c(4), c(1)], ["xq", "s", "big"])
        return L(p, 333)

    want = rows(list(build(JScan, JF, JP, JL, jir, jbs).execute(0, JCtx())))
    got = rows(list(build(PScan, PF, PP, PL, pir, [carry(b) for b in jbs])
                    .execute(0, PCtx(device="cpu"))))
    assert got == want and len(got) == 333


def test_arrow_and_pandas_interop_match_reference():
    import pyarrow as pa

    cols, valid = _table(200, 41)
    rb = pa.RecordBatch.from_arrays(
        [pa.array(list(v) if v.dtype == object else v,
                  mask=None if c not in valid else ~valid[c]) for c, v in cols.items()],
        names=list(cols))
    jb = jbatch.Batch.from_arrow(rb)
    pbx = pbatch.Batch.from_arrow(rb, device="cpu")
    ref = carry(jb)
    for i in range(len(cols)):
        assert torch.equal(pbx.device.validity[i], ref.device.validity[i])
        assert torch.equal(pbx.device.values[i], ref.device.values[i])
    assert pbx.to_arrow().equals(jb.to_arrow())
    assert pbx.to_pydict() == jb.to_pydict()
    df = jb.to_pandas()
    assert rows([pbatch.Batch.from_pandas(df, device="cpu")]) == rows([jb])
