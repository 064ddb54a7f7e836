"""Residual join conditions in the port against the JAX join: inner, left,
left-semi and left-anti joins (build on the right) through the broadcast
hash join and the sort-merge join, over a unique dense build, a unique
wide build, a duplicate-keyed build, two packed keys and an empty build,
with conditions over both sides (arithmetic with a cast, an IN list holding
a NULL, a LIKE over a dictionary string, a CASE) and a condition over one
side only. Rows must be equal as sets, every value exact."""

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.joins.bhj import BroadcastHashJoinExec as JBHJ
from auron_tpu.exec.joins.smj import SortMergeJoinExec as JSMJ
from auron_tpu.exprs import ir as jir
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as PT
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec as PSMJ
from auron_tpu_torch.exprs import ir as pir
from torch_carry import canon, carry, jax_batch, rows

JOIN_TYPES = ("inner", "left", "left_semi", "left_anti")
SHAPES = ("lut", "sorted_unique", "duplicates", "two_keys", "empty_build")
TAGS = np.array(["new", "sale", "clearance", "eco"], dtype=object)


def _case(shape: str, rng):
    """(probe batches, build batch, number of keys). Probe columns: keys,
    price (float64), q (int32); build columns: keys, w (int64, nullable),
    tag (string)."""
    n_keys = 2 if shape == "two_keys" else 1
    if shape == "two_keys":
        nb = 300
        bcols = {"b0": rng.integers(1, 40, nb, dtype=np.int64),
                 "b1": rng.integers(2_450_815, 2_450_830, nb).astype(np.int32)}
    elif shape == "lut":
        nb = 500
        bcols = {"b0": np.arange(1, nb + 1, dtype=np.int64)}
    elif shape == "sorted_unique":
        nb = 400
        bcols = {"b0": rng.choice(np.arange(0, 10**12, 7919, dtype=np.int64), nb, replace=False)}
    elif shape == "duplicates":
        nb = 600
        bcols = {"b0": rng.integers(1, 300, nb, dtype=np.int64)}
    else:
        nb = 0
        bcols = {"b0": np.zeros(0, np.int64)}
    bcols["w"] = rng.integers(0, 9, nb, dtype=np.int64)
    bcols["tag"] = TAGS[rng.integers(0, len(TAGS), nb)]
    build = jax_batch(bcols, {"w": rng.random(nb) > 0.1, "b0": rng.random(nb) > 0.05})
    probes = []
    for n in (700, 300):
        if shape == "two_keys":
            pcols = {"k0": rng.integers(-3, 45, n, dtype=np.int64),
                     "k1": rng.integers(2_450_810, 2_450_835, n).astype(np.int32)}
        elif shape == "sorted_unique":
            pcols = {"k0": np.where(rng.random(n) < 0.7, rng.choice(bcols["b0"], n),
                                    rng.integers(0, 10**12, n))}
        else:
            pcols = {"k0": rng.integers(0, 600, n, dtype=np.int64)}
        pcols["price"] = np.round(rng.gamma(2.0, 25.0, n), 2)
        pcols["q"] = rng.integers(1, 100, n).astype(np.int32)
        probes.append(jax_batch(pcols, {"k0": rng.random(n) > 0.1, "q": rng.random(n) > 0.1}))
    return probes, build, n_keys


def _condition(ir, T, which: str, n_keys: int):
    """A condition over the combined (probe ++ build) schema."""
    price, q = ir.col(n_keys), ir.col(n_keys + 1)
    w, tag = ir.col(2 * n_keys + 2), ir.col(2 * n_keys + 3)
    if which == "arith_cast":  # price > w * 10 (w NULL: the pair never matches)
        return ir.BinaryOp("gt", price, ir.BinaryOp("mul", ir.Cast(w, T.FLOAT64), ir.lit(10.0)))
    if which == "in_null_item":  # NULL when w misses the list: no match
        return ir.In(w, (1, 2, 3, None))
    if which == "like_or":
        return ir.BinaryOp("or", ir.Like(tag, "%a%"), ir.BinaryOp("lt", q, ir.lit(30)))
    if which == "case":
        return ir.BinaryOp("gt", ir.Case(((ir.BinaryOp("lt", price, ir.lit(40.0)), w),),
                                         ir.Cast(q, T.INT64)), ir.lit(4))
    return ir.BinaryOp("gt", q, ir.lit(50))  # probe side only


CONDITIONS = ("arith_cast", "in_null_item", "like_or", "case", "probe_only")


def _keys(ir, n: int):
    return [ir.col(i) for i in range(n)]


def _run_both(op, join_type, probes, build, n_keys, cond):
    jl, jr = JScan([probes], probes[0].schema), JScan([[build]], build.schema)
    jc = _condition(jir, JT, cond, n_keys)
    if op == "smj":
        j = JSMJ(jl, jr, _keys(jir, n_keys), _keys(jir, n_keys), join_type, condition=jc)
    else:
        j = JBHJ(jl, jr, _keys(jir, n_keys), _keys(jir, n_keys), join_type,
                 build_side="right", condition=jc)
    want = canon(rows(list(j.execute(0, JCtx(conf=JConf({}))))))
    pprobes, pbuild = [carry(b) for b in probes], carry(build)
    pl, pr = PScan([pprobes], pprobes[0].schema), PScan([[pbuild]], pbuild.schema)
    pc = _condition(pir, PT, cond, n_keys)
    if op == "smj":
        p = PSMJ(pl, pr, _keys(pir, n_keys), _keys(pir, n_keys), join_type, condition=pc)
    else:
        p = PBHJ(pl, pr, _keys(pir, n_keys), _keys(pir, n_keys), join_type,
                 build_side="right", condition=pc)
    assert p.schema.names == list(j.schema.names)
    return canon(rows(list(p.execute(0, PCtx(device="cpu"))))), want


@pytest.mark.parametrize("cond", CONDITIONS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("op", ["bhj", "smj"])
def test_join_condition_matches_reference(op, join_type, shape, cond):
    rng = np.random.default_rng(SHAPES.index(shape) * 10 + CONDITIONS.index(cond))
    probes, build, n_keys = _case(shape, rng)
    got, want = _run_both(op, join_type, probes, build, n_keys, cond)
    assert got == want
    n_probe = len(rows(probes))
    if join_type == "left":
        # every probe row at least once, unmatched ones with NULL build columns
        assert len(got) >= n_probe
    if join_type in ("left_semi", "left_anti"):
        semi, _ = _run_both(op, "left_semi", probes, build, n_keys, cond)
        anti, _ = _run_both(op, "left_anti", probes, build, n_keys, cond)
        assert len(semi) + len(anti) == n_probe


def test_condition_narrows_matches():
    """The condition removes pairs: fewer inner rows than without it, and
    the left join adds those probe rows back with NULL build columns."""
    rng = np.random.default_rng(5)
    probes, build, n_keys = _case("duplicates", rng)
    inner, _ = _run_both("bhj", "inner", probes, build, n_keys, "arith_cast")
    plain = PBHJ(PScan([[carry(b) for b in probes]], carry(probes[0]).schema),
                 PScan([[carry(build)]], carry(build).schema), [pir.col(0)], [pir.col(0)],
                 "inner", build_side="right")
    everything = rows(list(plain.execute(0, PCtx(device="cpu"))))
    assert 0 < len(inner) < len(everything)
    left, _ = _run_both("bhj", "left", probes, build, n_keys, "arith_cast")
    assert sum(r[n_keys + 2] is None for r in left) > 0
