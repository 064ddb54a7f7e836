"""Slice 12: the LIST type, ``GenerateExec`` and the generate classes of the
port against the JAX package, on the CPU.

- LIST columns round-trip through ``Batch.from_numpy``/``from_arrow``,
  ``to_numpy``/``to_pydict``/``to_arrow`` and ``device_concat`` (with
  vocabularies whose lists all have one length, which an ``out[:] = ...``
  fill would broadcast);
- ``explode``, ``pos_explode`` (each with and without ``outer``) and
  ``json_tuple`` equal the JAX ``GenerateExec`` on the same batches, row
  for row in emission order and batch for batch (each output chunk at the
  same capacity), also past one 65,536-row chunk; the explode makes one
  blocking read per input batch;
- the reference's ``B.generate`` and ``scalar_func`` protos decode in both
  planners to the same answers, and ``host_udtf`` takes its generated
  columns from the UDTF registry;
- ``run_generate_class`` (the reference's 42nd class) equals the JAX
  function and the numpy oracle; ``run_tag_revenue_class`` (the explode
  over the whole fact) equals the JAX run of the same plan proto, the
  port's planner run of that proto and the oracle (counts exact, sums at
  rel 1e-9);
- both classes run with JAX, pyarrow, pandas and protobuf unavailable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.bridge import api
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.generate_exec import GenerateExec as JGen
from auron_tpu.exprs import ir as jir
from auron_tpu.models import tpcds as jt
from auron_tpu.plan import builders as B
from auron_tpu.plan import planner as jplanner

from auron_tpu_torch import types as PT
from auron_tpu_torch.columnar.batch import Batch as PBatch, device_concat
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.generate_exec import GenerateExec as PGen
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.plan import fusion as pfusion
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import carry, rows, run_tree
from torch_classes import SF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIST_S = PT.DataType(PT.TypeKind.LIST, inner=(PT.STRING,))
LIST_I = PT.DataType(PT.TypeKind.LIST, inner=(PT.INT32,))
EQUAL_LEN = [["a", "b"], ["c", "d"], ["a", "b"], ["e", "f"]]  # one length: no broadcast
JSONS = ['{"a": 1, "b": "x"}', '{"a": [1, 2]}', "bad", '{"b": null, "c": {"d": 3}}', "", None]


# ---------------------------------------------------------------------------
# the LIST type
# ---------------------------------------------------------------------------


def test_list_round_trip_with_equal_length_lists_nulls_and_empties():
    schema = PT.Schema((PT.Field("id", PT.INT64), PT.Field("l", LIST_S), PT.Field("n", LIST_I)))
    ls = EQUAL_LEN + [[], None, ["x", None]]
    li = [[1, 2], [3, 4], [5, 6], [7, 8], [], None, [None, 9]]
    valid_l = np.array([x is not None for x in ls])
    b = PBatch.from_numpy([np.arange(7, dtype=np.int64), ls, li], schema,
                          [None, valid_l, np.array([x is not None for x in li])], device="cpu")
    assert b.device.values[1].dtype == torch.int32
    assert b.to_pydict() == {"id": list(range(7)), "l": ls, "n": li}
    v, m = b.to_numpy()["l"]
    assert v.dtype == object and list(v) == ls and m.tolist() == valid_l.tolist()
    rb = b.to_arrow()
    assert rb.schema.field("l").type == pa.list_(pa.string())
    assert rb.column(1).to_pylist() == ls
    back = PBatch.from_arrow(rb, device="cpu")
    assert back.schema == b.schema and back.to_pydict() == b.to_pydict()
    both = device_concat([b, back])
    assert both.to_pydict()["l"] == ls + ls
    # nested vocabularies are laid end to end, one entry per row: a merge by
    # Python equality would take [0.0] for [-0.0] (ROADMAP Queue 3)
    assert len(both.dicts[1]) == len(b.dicts[1]) + len(back.dicts[1]) == 2 * len(ls)
    # the reference's batch of the same Arrow data carries over entry for entry
    jb = JBatch.from_arrow(rb)
    assert rows([carry(jb)]) == rows([b]) == rows([jb])


def test_list_types_convert_to_and_from_arrow():
    nested = PT.DataType(PT.TypeKind.LIST, inner=(LIST_I,))
    assert nested.to_arrow() == pa.list_(pa.list_(pa.int32()))
    assert PT.DataType.from_arrow(pa.list_(pa.list_(pa.int32()))) == nested
    assert PT.DataType.from_arrow(pa.large_list(pa.string())) == LIST_S


# ---------------------------------------------------------------------------
# GenerateExec against the reference
# ---------------------------------------------------------------------------


def _jax_batches(n_rows=(400, 7, 300), seed=5, max_len=4):
    rng = np.random.default_rng(seed)
    pool_s = ["a", "b", "", "üb", "c,d", None]
    out = []
    for n in n_rows:
        ls, li, s = [], [], []
        for _ in range(n):
            k = int(rng.integers(0, max_len + 1))
            ls.append(None if rng.random() < 0.1 else
                      [pool_s[int(i)] for i in rng.integers(0, len(pool_s), k)])
            li.append(None if rng.random() < 0.1 else
                      [None if rng.random() < 0.1 else int(x) for x in rng.integers(-9, 9, k)])
            s.append(None if rng.random() < 0.1 else ",".join(
                pool_s[int(i)] or "" for i in rng.integers(0, 4, k)))
        ls[:4] = EQUAL_LEN[: min(4, n)][: len(ls[:4])]
        js = [JSONS[int(i)] for i in rng.integers(0, len(JSONS), n)]
        rb = pa.RecordBatch.from_arrays(
            [pa.array(np.arange(n, dtype=np.int64)), pa.array(ls, type=pa.list_(pa.string())),
             pa.array(li, type=pa.list_(pa.int32())), pa.array(s), pa.array(js)],
            names=["id", "ls", "li", "s", "js"])
        out.append(JBatch.from_arrow(rb))
    return out


def _gen_both(jbs, make):
    """(port batches, reference batches, port metrics) of the generate
    ``make(Scan, Gen, ir, T)`` over the same batches."""
    schema = jbs[0].schema
    jop = make(JScan([jbs], schema), JGen, jir, JT)
    want = list(jop.execute(0, JCtx()))
    pbs = [carry(b) for b in jbs]
    pop = make(PScan([pbs], pbs[0].schema), PGen, pir, PT)
    ctx = PCtx(device="cpu")
    got = list(pop.execute(0, ctx))
    return got, want, ctx.metrics.values


def _assert_same_batches(got, want):
    assert [b.capacity for b in got] == [b.capacity for b in want]
    assert rows(got) == rows(want)
    assert [f.dtype.kind.value for f in got[0].schema] == [f.dtype.kind.value
                                                           for f in want[0].schema]


GENERATES = {
    "explode": lambda S, G, ir, T: G(S, "explode", ir.col(1), [0, 3], elem_name="e"),
    "explode_outer": lambda S, G, ir, T: G(S, "explode", ir.col(1), [0], outer=True),
    "pos_explode": lambda S, G, ir, T: G(S, "pos_explode", ir.col(2), [0], pos_name="p"),
    "pos_explode_outer": lambda S, G, ir, T: G(S, "pos_explode", ir.col(2), [3, 0],
                                               outer=True),
    "explode_split": lambda S, G, ir, T: G(
        S, "explode", ir.ScalarFunc("split", (ir.col(3), ir.lit(","))), [0]),
    "explode_split_outer": lambda S, G, ir, T: G(
        S, "explode", ir.ScalarFunc("split", (ir.col(3), ir.lit("b"))), [0], outer=True),
    "json_tuple": lambda S, G, ir, T: G(S, "json_tuple", ir.col(4), [0, 1],
                                        json_fields=["a", "b", "c"]),
}


@pytest.mark.parametrize("name", sorted(GENERATES))
def test_generate_matches_the_reference(name):
    jbs = _jax_batches()
    got, want, metrics = _gen_both(jbs, GENERATES[name])
    _assert_same_batches(got, want)
    if name != "json_tuple":
        assert metrics["blocking_reads"] == len(jbs)  # the ragged total, once a batch
        assert metrics["exploded_rows"] == len(rows(got))
    assert metrics["generate_batches"] == len(jbs)


def test_explode_past_one_chunk_matches_the_reference():
    """~100,000 exploded rows of one input batch leave in two chunks (65,536
    and the rest, at their capacity buckets), as the reference's do."""
    jbs = _jax_batches((40_000,), seed=9, max_len=4)
    for name in ("pos_explode_outer", "explode"):
        got, want, metrics = _gen_both(jbs, GENERATES[name])
        assert len(got) == 2 and got[0].capacity == 1 << 16
        _assert_same_batches(got, want)
        assert metrics["generate_chunks"] == 2 and metrics["blocking_reads"] == 1


def test_generate_schema_and_refusals():
    pbs = [carry(b) for b in _jax_batches((5,))]
    scan = PScan([pbs], pbs[0].schema)
    g = PGen(scan, "pos_explode", pir.col(1), [0], pos_name="p", elem_name="e")
    assert [(f.name, f.dtype) for f in g.schema] == [("id", PT.INT64), ("p", PT.INT32),
                                                      ("e", PT.STRING)]
    with pytest.raises(TypeError, match="LIST"):
        PGen(scan, "explode", pir.col(0), [0])
    with pytest.raises(KeyError, match="not registered"):
        PGen(scan, "host_udtf", pir.col(1), [0], udtf="no_such_udtf")
    from auron_tpu_torch.bridge import udf

    udf.register_udtf("pairs", lambda s: [(s, 1)], PT.Schema((PT.Field("w", PT.STRING),
                                                              PT.Field("n", PT.INT32))))
    g = PGen(scan, "host_udtf", pir.col(1), [0], udtf="pairs")
    assert [(f.name, f.dtype) for f in g.schema] == [("id", PT.INT64), ("w", PT.STRING),
                                                      ("n", PT.INT32)]


# ---------------------------------------------------------------------------
# the planner variants
# ---------------------------------------------------------------------------


def _plans():
    jbs = _jax_batches((60, 50))
    schema = jbs[0].schema
    scan = B.memory_scan(schema, "src")
    gen = B.generate(scan, "pos_explode",
                     jir.ScalarFunc("split", (jir.col(3), jir.lit(","))), [0, 2],
                     outer=True, elem_name="tag", pos_name="at")
    proj = B.project(gen, [(jir.ScalarFunc("upper", (jir.col(3),)), "u"),
                           (jir.ScalarFunc("array_size", (jir.col(1),)), "k"),
                           (jir.ScalarFunc("xxhash64", (jir.col(0), jir.col(3))), "h")])
    jt_gen = B.generate(scan, "json_tuple", jir.col(4), [0], json_fields=["a", "c"])
    return jbs, {"pos_explode_split": gen, "project_functions": proj, "json_tuple": jt_gen}


@pytest.mark.parametrize("which", ["pos_explode_split", "project_functions", "json_tuple"])
def test_planner_variants_match_the_reference(which):
    jbs, plans = _plans()
    plan = plans[which]
    port_proto = pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())
    want = list(jplanner.plan_from_proto(plan).execute(0, JCtx(resources={"src": [jbs]})))
    op = pplanner.plan_from_proto(port_proto)
    got = list(op.execute(0, PCtx(device="cpu",
                                  resources={"src": [[carry(b) for b in jbs]]})))
    assert rows(got) == rows(want) and rows(got)
    if which == "pos_explode_split":
        assert isinstance(op, PGen) and op.outer and op.schema.names == ["id", "li", "at", "tag"]


def test_generate_ends_a_segment_and_fusion_changes_no_answer():
    """A GenerateExec is never part of a captured stage: fusion keeps it as
    an eager operator, and the answer is the same with fusion on and off."""
    jbs, plans = _plans()
    port_proto = pplanner._pb().PhysicalPlanNode.FromString(
        plans["project_functions"].SerializeToString())
    res = {"src": [[carry(b) for b in jbs]]}
    outs = []
    for mode in ("on", "off"):
        tree = pfusion.fuse_exec_tree(pplanner.plan_from_proto(port_proto),
                                      PConf({"exec.fuse.enable": mode}), "cpu")
        names = []
        stack = [tree]
        while stack:
            op = stack.pop()
            names.append(type(op).__name__)
            stack += op.children
        assert "GenerateExec" in names
        outs.append(rows(list(tree.execute(0, PCtx(device="cpu", resources=res)))))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the generate classes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _assert_answer(got: dict, want: dict, label: str):
    assert sorted(got) == sorted(want), label
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == np.asarray(w).shape, (label, k)
        if k == "rev":
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {k}")
        else:
            assert g.tolist() == list(w), (label, k)


def test_generate_class_equals_the_reference_and_the_oracle(data, monkeypatch):
    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    jtasks, ptasks = record_tasks(monkeypatch, api), record_tasks(monkeypatch, papi)
    jout = jt.run_generate_class(jd)
    want = {"tag": jout["tag"].to_numpy(object), "cnt": jout["cnt"].to_numpy(np.int64)}
    stats: dict = {}
    got = pt.run_generate_class(pdata, device="cpu", stats=stats)
    assert_same_tasks(jtasks, ptasks, "generate")
    _assert_answer(got, want, "generate vs auron_tpu")
    _assert_answer(pt.generate_class_oracle(pdata), want, "oracle vs auron_tpu")
    _assert_answer(jt.generate_class_oracle(jd).to_dict("list"), want, "reference oracle")
    c = stats["counters"]
    assert c["GenerateExec.exploded_rows"] == pt.exploded_rows(pdata)["generate"]
    assert c["GenerateExec.blocking_reads"] == c["GenerateExec.generate_batches"] == 1
    assert stats["timers"] and "fusion" in stats


def _tag_revenue_proto(fact_schema, item_schema):
    """The tag-revenue plan with the reference's builders: the fact BHJ item,
    explode(split(i_tags, ',')) keeping the price, partial and final
    aggregates by tag."""
    j = B.hash_join(B.memory_scan(fact_schema, "tr_fact"), B.memory_scan(item_schema, "tr_item"),
                    [jir.col(1)], [jir.col(0)], "inner", build_side="right")
    gen = B.generate(j, "explode", jir.ScalarFunc("split", (jir.col(9), jir.lit(","))), [4],
                     elem_name="tag")
    aggs = [("count_star", None, "cnt"), ("sum", jir.col(0), "rev")]
    p = B.hash_agg(gen, [(jir.col(1), "tag")], aggs, "partial")
    f = B.hash_agg(p, [(jir.col(0), "tag")],
                   [("count_star", None, "cnt"), ("sum", jir.col(2), "rev")], "final")
    return B.task(f)


def _by_tag(frame: dict) -> dict:
    order = np.argsort(np.asarray(frame["tag"]).astype(str), kind="stable")
    return {k: np.asarray(v)[order] for k, v in frame.items()}


def test_tag_revenue_class_equals_the_reference_run_of_the_same_proto(data, monkeypatch):
    """The port's task is the reference builders' proto of the plan, field
    by field, and both answers agree."""
    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    rows_per_batch = 16_384  # several input batches at this SF
    ss = jd.store_sales
    jfact = [JBatch.from_pandas(ss.iloc[i:i + rows_per_batch])
             for i in range(0, len(ss), rows_per_batch)]
    task = _tag_revenue_proto(jt._schema_of(ss), jt._schema_of(jd.item))
    api.put_resource("tr_fact", [jfact])
    api.put_resource("tr_item", [[JBatch.from_pandas(jd.item)]])
    try:
        frames = []
        with api.native_task(task.SerializeToString()) as h:
            while (rb := api.next_batch(h)) is not None:
                frames.append(rb.to_pandas())
    finally:
        api.remove_resource("tr_fact")
        api.remove_resource("tr_item")
    jout = pd.concat(frames)
    want = _by_tag({"tag": jout["tag"].to_numpy(object), "cnt": jout["cnt"].to_numpy(np.int64),
                    "rev": jout["rev"].to_numpy(np.float64)})

    fact = pt.to_batches(pdata.store_sales, 1, rows_per_batch, "cpu")
    ingested = {"fact": fact, "dd": pt.to_batches(pdata.date_dim, 1, device="cpu")[0],
                "item": pt.to_batches(pdata.item, 1, device="cpu")[0]}
    stats: dict = {}
    ptasks = record_tasks(monkeypatch, papi)
    got = pt.run_tag_revenue_class(pdata, device="cpu", stats=stats, ingested=ingested)
    assert_same_tasks([task.SerializeToString()], ptasks, "tag revenue")
    _assert_answer(got, want, "tag revenue vs auron_tpu")
    _assert_answer(pt.tag_revenue_class_oracle(pdata), want, "oracle vs auron_tpu")
    c = stats["counters"]
    assert c["GenerateExec.generate_batches"] == len(fact[0]) > 1
    assert c["GenerateExec.blocking_reads"] == len(fact[0])  # one a batch
    assert c["GenerateExec.exploded_rows"] == pt.exploded_rows(pdata)["tag_revenue"]

    # the same proto through the port's planner
    port_task = pplanner._pb().TaskDefinition.FromString(task.SerializeToString())
    root, stage, part, conf = pplanner.task_from_proto(port_task, "cpu")
    batches, _ = run_tree(root, {"tr_fact": fact, "tr_item": [ingested["item"]]}, stage, part,
                          conf, "cpu")
    planned = pt.collect(batches)
    _assert_answer(_by_tag(planned), want, "port planner vs auron_tpu")


def test_generate_classes_raise_without_a_card(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in pt.GENERATE_CLASSES:
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(pt, f"run_{name}_class")(data[1])


def test_generate_classes_run_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.005, 3)
        for name in tpcds.GENERATE_CLASSES:
            got = getattr(tpcds, f"run_{name}_class")(d, device="cpu")
            want = getattr(tpcds, f"{name}_class_oracle")(d)
            assert sorted(got) == sorted(want), name
            for k, w in want.items():
                if w.dtype.kind == "f":
                    assert np.allclose(got[k], w, rtol=1e-9, atol=0), (name, k)
                else:
                    assert got[k].tolist() == w.tolist(), (name, k)
        from auron_tpu_torch.functions import registry
        assert len(registry.names()) == 124
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow"))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
