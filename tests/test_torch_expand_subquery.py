"""The port's ExpandExec, the four small operators (RenameColumnsExec,
EmptyPartitionsExec, CoalesceBatchesExec, DebugExec), the task-context
expressions (SparkPartitionId, MonotonicId, RowNum) and ScalarSubquery
against the JAX package's on the same batches, on the CPU. Every plan is
built once with the JAX package's builders and decoded by both planners,
so each new plan and expression variant of the port's planner is built
from a proto. Rows are compared in emission order, exactly."""

import logging

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import planner as jplanner
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as PT
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import (
    CoalesceBatchesExec, DebugExec, EmptyPartitionsExec, ExpandExec, ProjectExec,
    RenameColumnsExec,
)
from auron_tpu_torch.exec.window_exec import WindowExec
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import carry, jax_batch, rows

CATS = np.array(["Books", "Home", "Music", "Sports"], dtype=object)


def _batches(sizes=(150, 90, 200), seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        out.append(jax_batch({
            "d": rng.integers(0, 6, n).astype(np.int64),
            "i": rng.integers(0, 9, n).astype(np.int64),
            "cat": CATS[rng.integers(0, len(CATS), n)],
            "q": rng.integers(1, 100, n).astype(np.int32),
            "p": np.round(rng.gamma(2.0, 25.0, n), 2),
        }, {"i": rng.random(n) > 0.1, "cat": rng.random(n) > 0.1}))
    return out


SCHEMA = _batches((1,))[0].schema


def _run_both(plan, jbs, partition=0, resources=None, conf=None):
    """(port rows, reference rows, port batches, reference batches) of
    ``plan`` over the partition-``partition`` stream ``jbs``."""
    extra = resources or {}
    port_proto = pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())
    parts = [[]] * partition
    jctx = JCtx(partition_id=partition, conf=JConf(dict(conf or {})),
                resources={"src": parts + [jbs], **extra})
    want = list(jplanner.plan_from_proto(plan).execute(partition, jctx))
    pctx = PCtx(partition_id=partition, conf=PConf(dict(conf or {})), device="cpu",
                resources={"src": parts + [[carry(b) for b in jbs]], **extra})
    got = list(pplanner.plan_from_proto(port_proto).execute(partition, pctx))
    return rows(got), rows(want), got, want


def _scan():
    return B.memory_scan(SCHEMA, "src")


# ---- ExpandExec ------------------------------------------------------------

NULL_I64 = jir.Literal(None, JT.INT64)
PROJECTIONS = {
    "rollup": [[jir.col(0), jir.col(1), jir.col(4), jir.lit(0)],
               [jir.col(0), NULL_I64, jir.col(4), jir.lit(1)],
               [NULL_I64, NULL_I64, jir.col(4), jir.lit(3)]],
    "cube": [[jir.col(0), jir.col(1), jir.col(4), jir.lit(0)],
             [jir.col(0), NULL_I64, jir.col(4), jir.lit(1)],
             [NULL_I64, jir.col(1), jir.col(4), jir.lit(2)],
             [NULL_I64, NULL_I64, jir.col(4), jir.lit(3)]],
    "strings_and_exprs": [[jir.col(2), jir.BinaryOp("mul", jir.col(3), jir.lit(2))],
                          [jir.Literal(None, JT.STRING), jir.col(3)]],
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_expand_matches_reference(name):
    projs = PROJECTIONS[name]
    names = [f"c{k}" for k in range(len(projs[0]))]
    plan = B.expand(_scan(), projs, names)
    got, want, pbs, _ = _run_both(plan, _batches())
    assert got == want
    assert len(pbs) == 3 * len(projs)  # one batch per projection per input batch
    assert [f.name for f in pbs[0].schema] == names


def test_expand_then_aggregate_matches_reference():
    """The q67 shape: ROLLUP through one expand and a partial + final
    aggregate by (d, i, gid)."""
    ex = B.expand(_scan(), PROJECTIONS["rollup"], ["d", "i", "price", "gid"])
    keys = [(jir.col(0), "d"), (jir.col(1), "i"), (jir.col(3), "gid")]
    aggs = [("sum", jir.col(2), "s"), ("count_star", None, "c")]
    plan = B.hash_agg(B.hash_agg(ex, keys, aggs, "partial"), keys, aggs, "final")
    got, want, _, _ = _run_both(plan, _batches())
    key = lambda r: tuple((x is None, x if x is not None else 0) for x in r[:3])  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [r[:3] + r[4:] for r in got] == [r[:3] + r[4:] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-9, atol=0)


# ---- the small operators --------------------------------------------------


def test_rename_columns_matches_reference():
    plan = B.rename_columns(_scan(), ["a", "b", "c", "e", "f"])
    got, want, pbs, wbs = _run_both(plan, _batches())
    assert got == want and [f.name for f in pbs[0].schema] == ["a", "b", "c", "e", "f"]
    assert pbs[0].schema.names == [f.name for f in wbs[0].schema]


def test_empty_partitions_matches_reference():
    plan = B.empty_partitions(SCHEMA, 4)
    for p in range(4):
        got, want, pbs, wbs = _run_both(plan, _batches(), partition=p)
        assert got == want == [] and pbs == wbs == []
    op = pplanner.plan_from_proto(
        pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString()))
    assert isinstance(op, EmptyPartitionsExec) and op.num_partitions == 4


@pytest.mark.parametrize("target", [0, 100, 250, 10_000])
def test_coalesce_batches_matches_reference(target):
    """Small batches (a filter leaves holes) merge toward the target: the
    same rows in the same order, in the same number of batches."""
    flt = B.filter_(_scan(), [jir.BinaryOp("gt", jir.col(4), jir.lit(40.0))])
    plan = B.coalesce_batches(flt, target)
    sizes = (150, 90, 3, 200, 40)
    got, want, pbs, wbs = _run_both(plan, _batches(sizes), conf={"batch.size": 256})
    assert got == want
    assert [b.num_rows() for b in pbs] == [b.num_rows() for b in wbs]
    assert len(pbs) < len(sizes) or target == 0


def test_debug_logs_each_batch_and_passes_it_through(caplog):
    plan = B.debug(_scan(), "probe")
    with caplog.at_level(logging.INFO, logger="auron_tpu_torch"):
        got, want, pbs, _ = _run_both(plan, _batches())
    assert got == want
    lines = [r.getMessage() for r in caplog.records if r.name == "auron_tpu_torch"]
    assert lines == [f"[probe] partition=0 batch={k} rows={n} cap={b.capacity}"
                     for k, (n, b) in enumerate(zip((150, 90, 200), pbs))]


def test_small_operators_keep_their_schemas():
    from auron_tpu_torch.exec.basic import MemoryScanExec

    schema = PT.Schema((PT.Field("x", PT.INT64), PT.Field("y", PT.STRING)))
    scan = MemoryScanExec([[]], schema)
    assert CoalesceBatchesExec(scan, 10).schema == schema
    assert DebugExec(scan).schema == schema
    assert RenameColumnsExec(scan, ["a", "b"]).schema.names == ["a", "b"]
    ex = ExpandExec(scan, [[pir.col(1), pir.lit(0)], [pir.Literal(None, PT.STRING), pir.lit(1)]],
                    ["y", "gid"])
    assert [f.dtype for f in ex.schema] == [PT.STRING, PT.INT32]


# ---- task-context expressions and scalar subqueries -------------------------


def _context_exprs(ir, T):
    return [(ir.col(0), "d"), (ir.SparkPartitionId(), "pid"), (ir.MonotonicId(), "mid"),
            (ir.RowNum(), "rn"),
            (ir.BinaryOp("sub", ir.col(4), ir.ScalarSubquery("avg_p", T.FLOAT64)), "dev"),
            (ir.ScalarSubquery("cut", T.INT32), "cut")]


@pytest.mark.parametrize("partition", [0, 3])
def test_context_expressions_across_batches_match_reference(partition):
    """A filter leaves holes in ``sel``; MonotonicId and RowNum number the
    live rows across the project's batches, after (partition << 33) for
    MonotonicId."""
    flt = B.filter_(_scan(), [jir.BinaryOp("gt", jir.col(3), jir.ScalarSubquery("cut", JT.INT32))])
    plan = B.project(flt, _context_exprs(jir, JT))
    res = {"avg_p": 50.0, "cut": 30}
    got, want, pbs, _ = _run_both(plan, _batches(), partition=partition, resources=res)
    assert got == want and len(pbs) == 3
    n = len(got)
    assert [r[2] for r in got] == [(partition << 33) + k for k in range(n)]
    assert [r[3] for r in got] == list(range(1, n + 1))
    assert {r[1] for r in got} == {partition} and {r[5] for r in got} == {30}
    decoded = pplanner.plan_from_proto(
        pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString()))
    assert isinstance(decoded, ProjectExec)
    assert decoded.exprs[1:4] == [pir.SparkPartitionId(), pir.MonotonicId(), pir.RowNum()]
    assert decoded.exprs[5] == pir.ScalarSubquery("cut", PT.INT32)


def test_scalar_subquery_null_value_matches_reference():
    plan = B.project(_scan(), [(jir.ScalarSubquery("v", JT.INT64), "v")])
    got, want, _, _ = _run_both(plan, _batches(), resources={"v": None})
    assert got == want and {r[0] for r in got} == {None}


def test_missing_scalar_subquery_raises_naming_it():
    plan = B.filter_(_scan(), [jir.BinaryOp("gt", jir.col(4),
                                            jir.ScalarSubquery("q9_avg", JT.FLOAT64))])
    with pytest.raises(KeyError, match="q9_avg"):
        _run_both(plan, _batches())
    pb = carry(_batches()[0])
    from auron_tpu_torch.exprs.eval import Evaluator

    with pytest.raises(KeyError, match="q9_avg"):
        Evaluator(pb.schema).evaluate(pb, [pir.ScalarSubquery("q9_avg", PT.FLOAT64)])


def test_row_offset_is_tracked_only_when_read():
    """Without a MonotonicId or RowNum the project reads no live count."""
    from auron_tpu_torch.exec import basic

    assert not basic._uses_row_offset(pir.BinaryOp("add", pir.col(0), pir.lit(1)))
    assert basic._uses_row_offset(pir.Case(((pir.lit(True), pir.RowNum()),)))
    assert basic._uses_row_offset(pir.BinaryOp("add", pir.MonotonicId(), pir.lit(1)))


# ---- the window variant from a proto ----------------------------------------


def test_window_variant_matches_reference():
    plan = B.window(_scan(), [jir.col(0)], [(jir.col(3), JSpec(asc=False)), (jir.col(4), JSpec())],
                    [("rank", None, None, 0, False, "rk"),
                     ("lag", None, jir.col(2), 2, False, "prev_cat"),
                     ("agg", "sum", jir.col(4), 1, False, "run"),
                     ("agg", "max", jir.col(2), 1, True, "top_cat")])
    got, want, pbs, _ = _run_both(plan, _batches())
    assert [r[:7] + r[8:] for r in got] == [r[:7] + r[8:] for r in want]
    np.testing.assert_allclose([r[7] for r in got], [r[7] for r in want], rtol=1e-9, atol=1e-9)
    op = pplanner.plan_from_proto(
        pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString()))
    assert isinstance(op, WindowExec) and op.funcs[0][0].offset == 1
    assert [f.name for f in pbs[0].schema][-4:] == ["rk", "prev_cat", "run", "top_cat"]


def test_generate_variant_still_raises():
    """The generate variant decodes since slice 12 (tests/test_torch_generate.py);
    an explode of a column that is not a LIST still raises when the plan is
    decoded, in both packages."""
    plan = B.generate(_scan(), "explode", jir.col(0), [0])
    with pytest.raises(AssertionError, match="LIST"):
        jplanner.plan_from_proto(plan)
    with pytest.raises(TypeError, match="LIST"):
        pplanner.plan_from_proto(
            pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString()))
