"""Public names of the reference the port had lacked, each held against the
reference on the CPU: ``ShuffledHashJoinExec`` (``exec/joins/bhj.py:183``),
``Batch.from_pydict`` and ``Batch.to_pandas`` (``columnar/batch.py:255``,
``:341``), ``ExecOperator.collect`` and ``collect_pydict``
(``exec/base.py:133``, ``:141``) and ``utils/config.generate_doc``
(``:159``)."""

import decimal

import numpy as np
import pandas as pd
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import FilterExec as JFilter, MemoryScanExec as JScan
from auron_tpu.exec.joins import ShuffledHashJoinExec as JSHJ
from auron_tpu.exprs import ir as jir
from auron_tpu.utils import config as jconfig

from auron_tpu_torch import types as PT
from auron_tpu_torch.columnar.batch import Batch as PBatch
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import FilterExec as PFilter, MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec, ShuffledHashJoinExec as PSHJ
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.utils import config as pconfig

DATA = {"k": [3, 1, None, 2, 1, 5], "s": ["a", "b", "c", None, "b", "e"],
        "x": [1.5, None, 2.25, 3.0, -1.0, 0.5],
        "d": [decimal.Decimal("1.25"), None, decimal.Decimal("-3.50"), decimal.Decimal("0.01"),
              decimal.Decimal("7.00"), decimal.Decimal("2.10")]}


def _schemas():
    fields = (("k", "INT64"), ("s", "STRING"), ("x", "FLOAT64"))
    j = JT.Schema(tuple(JT.Field(n, getattr(JT, t), True) for n, t in fields)
                  + (JT.Field("d", JT.decimal(9, 2), True),))
    p = PT.Schema(tuple(PT.Field(n, getattr(PT, t), True) for n, t in fields)
                  + (PT.Field("d", PT.decimal(9, 2), True),))
    return j, p


@pytest.mark.parametrize("typed", [True, False])
def test_from_pydict_equals_the_reference(typed):
    js, ps = _schemas()
    data = DATA if typed else {k: v for k, v in DATA.items() if k != "d"}
    want = JBatch.from_pydict(data, js if typed else None)
    got = PBatch.from_pydict(data, ps if typed else None, device="cpu")
    assert got.to_pydict() == want.to_pydict()
    assert [f.name for f in got.schema] == [f.name for f in want.schema]
    assert [str(f.dtype) for f in got.schema] == [str(f.dtype) for f in want.schema]


def test_to_pandas_equals_the_reference():
    js, ps = _schemas()
    want = JBatch.from_pydict(DATA, js).to_pandas()
    got = PBatch.from_pydict(DATA, ps, device="cpu").to_pandas()
    pd.testing.assert_frame_equal(got, want)


def test_collect_and_collect_pydict_equal_the_reference():
    js, ps = _schemas()
    jb, pb_ = JBatch.from_pydict(DATA, js), PBatch.from_pydict(DATA, ps, device="cpu")
    pred = {m: m.BinaryOp("gt", m.col(2), m.lit(0.9)) for m in (jir, pir)}
    jop = JFilter(JScan([[jb]], js), [pred[jir]])
    pop = PFilter(PScan([[pb_]], ps), [pred[pir]])
    want = jop.collect_pydict()
    assert pop.collect_pydict(ctx=PCtx(device="cpu")) == want
    assert want["k"] == [3, None, 2]
    out = pop.collect(0, PCtx(device="cpu"))
    assert isinstance(out, PBatch) and out.to_pydict() == want
    # nothing out: an empty batch of the operator's schema on the context's device
    none = PFilter(PScan([[pb_]], ps), [pir.BinaryOp("gt", pir.col(2), pir.lit(1e9))])
    empty = none.collect(0, PCtx(device="cpu"))
    assert empty.to_pydict()["k"] == [] and empty.schema == ps and empty.torch_device.type == "cpu"
    assert JFilter(JScan([[jb]], js), [jir.BinaryOp("gt", jir.col(2), jir.lit(1e9))]) \
        .collect_pydict()["k"] == []


@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "left_anti"])
def test_shuffled_hash_join_equals_the_reference(join_type):
    left = {"k": [1, 2, 2, 3, None, 4], "v": [10, 20, 21, 30, 40, 50]}
    right = {"k": [2, 3, 3, 9], "w": [200, 300, 301, 900]}
    out = []
    for T, Batch, Scan, SHJ, ir, ctx in ((JT, JBatch, JScan, JSHJ, jir, JCtx()),
                                         (PT, PBatch, PScan, PSHJ, pir, PCtx(device="cpu"))):
        kw = {} if Batch is JBatch else {"device": "cpu"}
        ls = T.Schema((T.Field("k", T.INT64, True), T.Field("v", T.INT64, True)))
        rs = T.Schema((T.Field("k2", T.INT64, True), T.Field("w", T.INT64, True)))
        lb = Batch.from_pydict(left, ls, **kw)
        rb = Batch.from_pydict({"k2": right["k"], "w": right["w"]}, rs, **kw)
        op = SHJ(Scan([[lb]], ls), Scan([[rb]], rs), [ir.col(0)], [ir.col(0)], join_type,
                 build_side="right", cached_build_id="never_cached")
        assert op.cached_build_id is None
        d = op.collect_pydict() if Batch is JBatch else op.collect_pydict(ctx=ctx)
        out.append(sorted(zip(*d.values()), key=repr))
    assert out[0] == out[1]
    assert isinstance(op, BroadcastHashJoinExec) and not ctx.resources


def test_generate_doc_equals_the_reference(monkeypatch):
    """The same registry gives the same Markdown, row for row; the port's
    own table lists each of its options once, in key order."""
    opts = [("b.key", 3, "exec", "a count"), ("a.key", "off", "obs", "a mode"),
            ("c.key", 0.5, "memory", "a share")]
    reg = {}
    for mod in (jconfig, pconfig):
        monkeypatch.setattr(mod, "_REGISTRY", {})
        for key, default, cat, doc in opts:
            mod.ConfigOption(key, default, str, cat, doc)
        reg[mod] = mod.generate_doc()
    assert reg[pconfig] == reg[jconfig]
    assert reg[pconfig].splitlines()[2].startswith("| `a.key` | `'off'` | obs |")
    monkeypatch.undo()
    rows = pconfig.generate_doc().splitlines()
    assert rows[:2] == jconfig.generate_doc().splitlines()[:2]
    keys = [r.split("`")[1] for r in rows[2:]]
    assert keys == sorted(pconfig._REGISTRY) and "batch.size" in keys
    assert np.all([r.count("|") >= 5 for r in rows])
