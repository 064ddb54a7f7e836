"""The customer-basket class (collect_set, collect_list, named_struct,
map_from_arrays over a file shuffle of LIST states) at SF 0.01: the port
from ``TaskDefinition`` bytes against the numpy oracle, and against the
JAX package running the same task bytes (its own bridge, its own shuffle
files) on the same data. Keys, struct fields, map entries and every
collect_set compare exactly, in order; collect_list as a multiset per
group (``tpcds.basket_mismatch``), though both packages keep input
order. The answer leaves through the C data interface: STRUCT, MAP and
LIST columns as ``+s``, ``+m`` and ``+l``, read by pyarrow."""

import ctypes
import os
import subprocess
import sys
import textwrap

import pyarrow as pa
import pytest

from auron_tpu.bridge import api as japi
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider
from auron_tpu.models import tpcds as jt

from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch.exprs.ir import col
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.plan.planner import tree_from_plan

SF = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


@pytest.fixture(scope="module")
def port_answer(data):
    stats: dict = {}
    hb = pt.run_basket_class(data[1], device="cpu", stats=stats)
    return hb, stats


def _jax_answer(jd, tmp_path, n_map=4, n_reduce=4, limit=100) -> dict:
    """The JAX package running the port's task bytes of the class."""
    ing = jt.ingest_q3(jd, n_map)
    res = {"basket_fact": ing["fact"], "basket_dd": [ing["dd"]] * n_map,
           "basket_item": [ing["it"]] * n_map}
    m = pt.basket_map_plan()
    part = B.hash_partitioning([col(0)], n_reduce)
    pairs = []
    try:
        for p in range(n_map):
            d, i = str(tmp_path / f"m{p}.data"), str(tmp_path / f"m{p}.index")
            task = B.task(B.shuffle_writer(m, part, d, i), 1, p)
            with japi.native_task(task.SerializeToString(), res) as h:
                assert japi.next_batch(h) is None
            pairs.append((d, i))
        res["basket_ex0"] = JProvider(pairs)
        reduce_plan = pt.basket_reduce_plan(B.ipc_reader(tree_from_plan(m).schema, "basket_ex0"),
                                            limit)
        tops = []
        for r in range(n_reduce):
            with japi.native_task(B.task(reduce_plan, 2, r).SerializeToString(), res) as h:
                while (rb := japi.next_batch(h)) is not None:
                    tops.append(JBatch.from_arrow(rb))
        top = pt.basket_top_plan(tree_from_plan(reduce_plan).schema, limit)
        out = []
        with japi.native_task(B.task(top, 3, 0).SerializeToString(),
                              {"basket_top": [tops]}) as h:
            while (rb := japi.next_batch(h)) is not None:
                out.append(rb)
    finally:
        for k in pt._BASKET_BUILDS:
            japi.remove_resource(k)
    return pa.Table.from_batches(out).to_pydict()


def test_basket_class_matches_the_oracle(data, port_answer):
    hb, stats = port_answer
    got = hb.to_pydict()
    want = pt.basket_class_oracle(data[1])
    assert pt.basket_mismatch(got, want) is None
    assert len(got["ss_customer_sk"]) == 100 and got["ss_customer_sk"][0] is None
    assert got["singles"] == want["singles"]  # input order, as the reference keeps it
    assert stats["shuffle_bytes"] > 0 and stats["map_s"] > 0 and stats["top_s"] > 0
    assert stats["task_bytes"] > 0 and stats["counters"]["HashAggExec.generic_batches"] > 0


def test_basket_class_matches_the_reference_from_the_same_bytes(data, port_answer, tmp_path):
    want = _jax_answer(data[0], tmp_path)
    assert pt.basket_mismatch(port_answer[0].to_pydict(), want) is None


def test_basket_answer_leaves_through_the_c_data_interface(data, port_answer):
    hb, _ = port_answer
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(hb, ctypes.addressof(arr), ctypes.addressof(sch))
    rb = pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))
    lst = pa.list_(pa.int32())
    assert rb.schema.types == [pa.int64(), pa.struct([("years", lst), ("cats", lst)]),
                               pa.map_(pa.string(), pa.int32()), pa.list_(pa.int64())]
    assert [c.fmt for c in hb.columns] == ["l", "+s", "+m", "+l"]
    assert pt.basket_mismatch(rb.to_pydict(), pt.basket_class_oracle(data[1])) is None


def test_basket_class_runs_without_jax_arrow_pandas_or_protobuf():
    """The class and its answer's host Arrow batch need none of them: the
    port's own C data interface structs and Arrow IPC carry the nested
    columns."""
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.005, 3)
        hb = tpcds.run_basket_class(d, device="cpu")
        assert tpcds.basket_mismatch(hb.to_pydict(), tpcds.basket_class_oracle(d)) is None
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
