"""The port's left broadcast hash join (build on the right) and the If
expression against auron_tpu: NULL-keyed and unmatched probe rows stay
live with NULL build columns, for every build shape the port prepares
(dense LUT, sorted unique, duplicate-keyed, all-NULL)."""

import numpy as np
import pytest
import torch

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.joins.bhj import BroadcastHashJoinExec as JBHJ
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import Evaluator as JEval
from auron_tpu import types as JT
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as T
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import Evaluator as PEval
from torch_carry import canon, carry, jax_batch, rows


def _probe(rng, n, key_hi, null_share):
    return jax_batch({"k": rng.integers(0, key_hi, n, dtype=np.int64),
                      "price": np.round(rng.gamma(2.0, 25.0, n), 2)},
                     {"k": rng.random(n) >= null_share})


def _build(kind, rng):
    if kind == "lut":  # small dense range, unique
        sk = np.arange(1, 501, dtype=np.int64)
        valid = None
    elif kind == "sorted_unique":  # wide range, unique
        sk = rng.choice(np.arange(0, 10**12, 7919, dtype=np.int64), 400, replace=False)
        valid = None
    elif kind == "duplicates":
        sk = rng.integers(1, 300, 600, dtype=np.int64)
        valid = {"sk": rng.random(600) > 0.1}
    else:  # all build keys NULL
        sk = np.arange(1, 101, dtype=np.int64)
        valid = {"sk": np.zeros(100, bool)}
    return jax_batch({"sk": sk, "band": sk % 5}, valid)


@pytest.mark.parametrize("projection", [None, [0, 1, 2]])
@pytest.mark.parametrize("kind", ["lut", "sorted_unique", "duplicates", "all_null"])
def test_left_join_matches_reference(kind, projection):
    rng = np.random.default_rng(len(kind))
    key_hi = 10**12 if kind == "sorted_unique" else 600
    probes = [_probe(rng, 700, key_hi, 0.85), _probe(rng, 300, key_hi, 0.0)]
    if kind == "sorted_unique":  # make some probes hit
        build = _build(kind, rng)
        bk = np.asarray(build.to_pydict()["sk"], dtype=np.int64)
        probes.append(jax_batch({"k": rng.choice(bk, 200), "price": np.ones(200)}))
    else:
        build = _build(kind, rng)
    j = JBHJ(JScan([probes], probes[0].schema), JScan([[build]], build.schema),
             [jir.col(0)], [jir.col(0)], "left", build_side="right", projection=projection)
    want = canon(rows(list(j.execute(0, JCtx(conf=JConf({}))))))
    pprobes = [carry(b) for b in probes]
    pbuild = carry(build)
    p = PBHJ(PScan([pprobes], pprobes[0].schema), PScan([[pbuild]], pbuild.schema),
             [pir.col(0)], [pir.col(0)], "left", build_side="right", projection=projection)
    got = canon(rows(list(p.execute(0, PCtx(device="cpu")))))
    assert got == want
    n_probe = sum(len(rows([b])) for b in probes)
    if kind != "duplicates":
        assert len(got) == n_probe  # every probe row once
    assert sum(r[0] is None for r in got) == sum(r[0] is None for r in rows(probes))


def test_left_join_keeps_unsupported_shapes_refused():
    """Every join type runs with the build on either side since the join
    tail was ported; a join type or build side the reference does not
    know is still refused."""
    s = T.Schema((T.Field("k", T.INT64),))
    scan = PScan([[]], s)
    for jt, side in (("left", "left"), ("right", "right"), ("full", "right")):
        PBHJ(scan, scan, [pir.col(0)], [pir.col(0)], jt, build_side=side)
    for jt, side in (("cross", "right"), ("left", "middle")):
        with pytest.raises(ValueError):
            PBHJ(scan, scan, [pir.col(0)], [pir.col(0)], jt, build_side=side)


def _if_exprs(ir, T_):
    key = ir.If(ir.BinaryOp("lt", ir.col(0), ir.Literal(85, T_.INT32)),
                ir.Literal(None, T_.INT64), ir.col(1))
    widen = ir.If(ir.BinaryOp("gt", ir.col(1), ir.Literal(50_000, T_.INT64)),
                  ir.col(0), ir.col(1))  # int32 then, int64 else: unify to int64
    null_cond = ir.If(ir.IsNull(ir.col(1)), ir.Literal(-1, T_.INT64), ir.col(1))
    return [key, widen, null_cond]


def test_if_matches_reference():
    rng = np.random.default_rng(7)
    n = 1000
    jb = jax_batch({"q": rng.integers(1, 100, n).astype(np.int32),
                    "c": rng.integers(1, 100_000, n, dtype=np.int64)},
                   {"c": rng.random(n) > 0.04, "q": rng.random(n) > 0.05})
    want = JEval(jb.schema).evaluate(jb, _if_exprs(jir, JT))
    pb = carry(jb)
    got = PEval(pb.schema).evaluate(pb, _if_exprs(pir, T))
    for w, g in zip(want, got):
        assert g.dtype.kind.value == w.dtype.kind.value
        wm = np.asarray(w.validity)
        np.testing.assert_array_equal(g.validity.numpy(), wm)
        np.testing.assert_array_equal(g.values.numpy()[wm], np.asarray(w.values)[wm])
    assert got[1].values.dtype == torch.int64
