"""Slice 1 as a whole: the q42-class query (scan -> broadcast hash join ->
partial/final hash aggregate -> SortExec fetch 10) gives the same rows from
auron_tpu, from auron_tpu_torch's run_q42_class, and from auron_tpu_torch
fed the JAX builders' serialized TaskDefinition bytes; the data generator
and batching carry across bit for bit; the port imports no JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

from auron_tpu.exprs.ir import col as jcol
from auron_tpu.models import tpcds as jt
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import planner as jplanner

from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.ops import bitonic as pbitonic
from torch_carry import carry, rows

SF = 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _jax_q42_plan():
    """The q42-class plan exactly as auron_tpu.models.tpcds.run_q42_class
    builds it through the proto builders."""
    fact = B.memory_scan(jt._schema_of(jt.generate(0.001, 1).store_sales), "q42_fact")
    item = B.memory_scan(jt._schema_of(jt.generate(0.001, 1).item), "q42_item")
    j = B.hash_join(fact, item, [jcol(1)], [jcol(0)], "inner", build_side="right")
    pr = B.project(j, [(jcol(6), "brand"), (jcol(4), "p")])
    p = B.hash_agg(pr, [(jcol(0), "brand")], [("sum", jcol(1), "rev")], "partial")
    f = B.hash_agg(p, [(jcol(0), "brand")], [("sum", jcol(1), "rev")], "final")
    return B.sort(f, [(jcol(1), JSpec(asc=False)), (jcol(0), JSpec())], fetch=10)


def test_generate_matches_reference(data):
    jd, pd_ = data
    for name in ("store_sales", "date_dim", "item"):
        jdf, ptab = getattr(jd, name), getattr(pd_, name)
        assert list(jdf.columns) == ptab.schema.names
        for c in jdf.columns:
            s = jdf[c]
            valid = ~s.isna().to_numpy()
            np.testing.assert_array_equal(ptab.validity(c), valid)
            want = s.to_numpy()[valid]
            got = ptab.columns[c][valid]
            if pd.api.types.is_string_dtype(s.dtype):
                assert list(got) == list(want)
            else:
                np.testing.assert_array_equal(got, want.astype(got.dtype))
                assert got.dtype == np.dtype(str(s.dtype).lower())


@pytest.mark.parametrize("table,batch_rows", [("item", 50), ("store_sales", 20_000)])
def test_to_batches_matches_reference(data, table, batch_rows):
    jd, pd_ = data
    jparts = jt.to_batches(getattr(jd, table), 2, batch_rows=batch_rows)
    pparts = pt.to_batches(getattr(pd_, table), 2, batch_rows=batch_rows, device="cpu")
    assert [len(p) for p in jparts] == [len(p) for p in pparts]
    for jp, pp in zip(jparts, pparts):
        for jb, pbx in zip(jp, pp):
            ref = carry(jb)
            assert pbx.schema == ref.schema and pbx.capacity == ref.capacity
            assert torch.equal(pbx.device.sel, ref.device.sel)
            for i in range(len(ref.schema)):
                assert torch.equal(pbx.device.validity[i], ref.device.validity[i])
                assert torch.equal(pbx.device.values[i], ref.device.values[i])
                if ref.dicts[i] is not None:
                    assert list(pbx.dicts[i]) == list(ref.dicts[i])


def _assert_q42_equal(got: dict, want: pd.DataFrame):
    np.testing.assert_array_equal(got["brand"], want["brand"].to_numpy())
    np.testing.assert_allclose(got["rev"], want["rev"].to_numpy(), rtol=1e-9, atol=0)


def test_q42_three_ways(data):
    jd, pd_ = data
    want = jt.run_q42_class(jd)
    assert len(want) == 10
    # 1. the port's own entry point
    _assert_q42_equal(pt.run_q42_class(pd_, device="cpu"), want)
    # 2. the port driven by the JAX builders' serialized task bytes
    ingested = pt.ingest_q42(pd_, device="cpu")
    for k, v in ingested.items():
        papi.put_resource(k, v)
    try:
        task = B.task(_jax_q42_plan()).SerializeToString()
        with papi.native_task(task, device="cpu") as h:
            out = []
            while (b := papi.next_batch(h)) is not None:
                out.append(b)
    finally:
        for k in ingested:
            papi.remove_resource(k)
    got = pt.collect(out)
    _assert_q42_equal({"brand": got["brand"], "rev": got["rev"]}, want)
    # 3. the numpy oracle against the reference's pandas oracle
    _assert_q42_equal(pt.q42_class_oracle(pd_), jt.q42_class_oracle(jd))


def test_q42_through_bitonic_network(data, monkeypatch):
    """exec.device.sort.impl=pallas routes the SortExec through
    ordered_sort -> bitonic_sort; on CPU tensors that is the plain network."""
    jd, pd_ = data
    calls = []
    real = pbitonic._network
    monkeypatch.setattr(pbitonic, "_network", lambda x, P: calls.append(P) or real(x, P))
    got = pt.run_q42_class(pd_, device="cpu", conf={"exec.device.sort.impl": "pallas"})
    _assert_q42_equal(got, jt.run_q42_class(jd))
    assert len(calls) == 1  # one sort of the final aggregate's groups


def _describe(op) -> list:
    """Operator types + everything that defines them, as comparable text."""
    name = type(op).__name__
    d = [name, repr(op.schema)]
    if name == "ResourceScanExec":
        d.append(op.resource_id)
    elif name == "ProjectExec":
        d += [repr(op.exprs), op.names]
    elif name == "HashAggExec":
        d += [repr(op.groupings), repr(op.aggs), op.mode]
    elif name == "SortExec":
        d += [repr(op.sort_exprs), repr(op.specs), op.fetch]
    elif name == "BroadcastHashJoinExec":
        dr = op.driver
        d += [repr(dr.left_keys), repr(dr.right_keys), dr.join_type, dr.build_side,
              dr.projection, op.cached_build_id]
    return [d] + [_describe(c) for c in op.children]


def test_q42_exec_tree_matches_planner():
    task = B.task(_jax_q42_plan(), conf={"exec.fuse.enable": "off"})
    want, *_ = jplanner.task_from_proto(task)
    assert _describe(pt.q42_exec_tree()) == _describe(want)
    # the port's own planner, fed the same proto, builds the same tree
    from auron_tpu_torch.plan import planner as pplanner

    got, *_ = pplanner.task_from_proto(pplanner.decode_task(task.SerializeToString()))
    assert _describe(got) == _describe(want)


def test_port_imports_no_jax_pandas_arrow_or_protobuf():
    """Every module of the port imports, and q42 and q93 run from their
    TaskDefinition bytes (the port's codec decodes them), with no JAX,
    pandas, pyarrow or google.protobuf loaded (q93's shuffle without its
    general codec, which is pyarrow's)."""
    script = textwrap.dedent("""
        import pkgutil, sys
        import numpy as np
        import auron_tpu_torch
        for m in pkgutil.walk_packages(auron_tpu_torch.__path__, "auron_tpu_torch."):
            __import__(m.name)
        import chip_smoke
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.002, 3)
        st = {}
        got = tpcds.run_q42_class(d, device="cpu", stats=st)
        assert got["brand"].shape == (10,), got
        assert st["task_bytes"] > 0 and st["decode_s"] > 0, st
        st = {}
        # the shuffle's general codec (lz4 by default) is pa.Codec's: none
        # keeps the shuffle free of pyarrow
        q93 = tpcds.run_q93_class(d, n_map=2, n_reduce=2, device="cpu", stats=st,
                                  conf={"exec.shuffle.encoding.fallback.codec": "none"})
        assert np.array_equal(q93["rows"], tpcds.q93_class_oracle(d)["rows"]), q93
        assert st["task_bytes"] > 0, st
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow")
                     or m.startswith("google.protobuf"))
        print("BAD", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


def test_cuda_entry_without_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_q42_class(data[1])  # default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        papi.call_native(B.task(_jax_q42_plan()).SerializeToString())
