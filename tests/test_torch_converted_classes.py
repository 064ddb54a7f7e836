"""End to end on the CPU (SF 0.02): host plans through the port's
``convert_plan_json`` and the response's stages (``tpcds.run_converted``),
against the numpy oracles and the JAX package.

- q42, q93 (4 x 4), q3 (4 x 4) and the range-partitioned global sort
  equal their oracles (keys and counts exact, float sums at rel 1e-9; the
  range sort by ``range_sort_mismatch``);
- the range sort's reduce partitions equal the reference's partition by
  partition: the same response's stages run through the JAX package's
  bridge and planner on the CPU;
- the converted q93 segment under the port's ``MeshQueryDriver`` equals
  the JAX driver's on a 4-device CPU mesh, and the range exchange runs
  under the port's driver on both transports.
"""

import base64
import os
import tempfile

import numpy as np
import pandas as pd
import pytest

from auron_tpu.bridge import api as japi
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.convert.stages import ShuffleManager as JShuffleManager
from auron_tpu.convert.stages import StageSpec as JStageSpec
from auron_tpu.convert.stages import stage_task as jstage_task
from auron_tpu.models import tpcds as jt
from auron_tpu.parallel.mesh import make_mesh as jmake_mesh
from auron_tpu.parallel.mesh_driver import MeshQueryDriver as JDriver
from auron_tpu.proto import plan_pb2
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.models import tpcds as pt

from torch_carry import canon, rows

SF = 0.02
P = 4


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def test_q42_converted_equals_its_oracle(data):
    st: dict = {}
    got = pt.run_q42_converted(data[1], device="cpu", stats=st)
    want = pt.q42_class_oracle(data[1])
    assert got["brand"].tolist() == want["brand"].tolist()
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
    assert st["stages"] == 1 and st["convert_s"] > 0 and st["response_bytes"] > 0
    (task,) = st["tasks"]
    assert task["decode_s"] > 0 and task["plan_s"] > 0 and task["task_bytes"] > 0
    assert any(k.startswith("SortExec.") for k in st["timers"])


def _assert_q93(got, want):
    assert got["k_null"].tolist() == want["k_null"].tolist()
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)


def test_q93_converted_equals_its_oracle(data, tmp_path):
    st: dict = {}
    got = pt.run_q93_converted(data[1], device="cpu", stats=st, work_dir=str(tmp_path))
    _assert_q93(got, pt.q93_class_oracle(data[1]))
    assert st["stages"] == 2 and len(st["tasks"]) == 8 and len(st["stage_s"]) == 2
    assert st["shuffle_bytes"] > 0 and sum(st["partition_rows"]) == len(data[1].store_sales)
    assert [t["stage"] for t in st["tasks"]] == [0] * 4 + [1] * 4
    # the map outputs went where the stage's templates put them
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".data")]) == 4


def test_q3_converted_equals_its_oracle_and_the_plan_built_run(data):
    got = pt.run_q3_converted(data[1], device="cpu")
    want = pt.q3_class_oracle(data[1])
    for k in ("d_year", "i_brand_id"):
        assert got[k].tolist() == want[k].tolist()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    mine = pt.run_q3_class(data[1], device="cpu")
    np.testing.assert_allclose(got["s"], mine["s"], rtol=1e-9, atol=0)


def _jax_fact_parts(jd):
    return jt.to_batches(jd.store_sales, P)


def _run_stages_jax(resp: dict, resources: dict, n_map: int, work: str) -> list[list]:
    """The response's stages as the JVM runs them, through the JAX
    package's bridge: each task from its TaskDefinition bytes, map outputs
    committed to its ShuffleManager and handed to the next stage's
    ipc_reader. Returns each final task's rows."""
    specs = [JStageSpec(i, plan_pb2.PhysicalPlanNode.FromString(base64.b64decode(s["plan_b64"])),
                        s["exchange_id"], s["num_output_partitions"],
                        list(s["input_exchange_ids"]))
             for i, s in enumerate(resp["root"]["stages"])]
    keys = list(resources)
    for k, v in resources.items():
        japi.put_resource(k, v)
    shuffle, width, outs = JShuffleManager(), {}, []
    try:
        for spec in specs:
            n = width[spec.input_exchange_ids[0]] if spec.input_exchange_ids else n_map
            for p in range(n):
                h = japi.call_native(jstage_task(spec, p, work).SerializeToString())
                got = []
                while (b := japi.next_batch(h)) is not None:
                    got += b.to_pylist()
                japi.finalize_native(h)
                if spec.is_final:
                    outs.append(got)
                else:
                    shuffle.register_map_output(
                        spec.exchange_id, p, spec.data_template.format(work_dir=work, partition=p),
                        spec.index_template.format(work_dir=work, partition=p))
            if not spec.is_final:
                width[spec.exchange_id] = spec.num_output_partitions
                japi.put_resource(spec.exchange_id, shuffle.block_provider(spec.exchange_id))
                keys.append(spec.exchange_id)
    finally:
        for k in keys:
            japi.remove_resource(k)
    return outs


def _port_rows(part: dict) -> list[tuple]:
    valid = part["ss_customer_sk_valid"]
    return [(int(d), int(i), int(c) if v else None, float(p)) for d, i, c, v, p in zip(
        part["ss_sold_date_sk"], part["ss_item_sk"], part["ss_customer_sk"], valid,
        part["ss_ext_sales_price"])]


def test_range_sort_equals_its_oracle_and_the_reference_partition_by_partition(data):
    jd, pd_ = data
    st: dict = {}
    parts = pt.run_range_sort_converted(pd_, device="cpu", stats=st)
    assert pt.range_sort_mismatch(parts, pt.range_sort_oracle(pd_)) is None
    assert st["stages"] == 2 and sum(st["partition_rows"]) == len(pd_.store_sales)
    assert all(r > 0 for r in st["partition_rows"])
    assert "SortExec.sort_time" in st["timers"]
    resp = pt.convert_host_plan(pt.range_sort_host_plan(pd_, P))
    with tempfile.TemporaryDirectory() as work:
        want = _run_stages_jax(resp, {"rs_fact": _jax_fact_parts(jd)}, P, work)
    assert len(want) == len(parts) == P
    for g, w in zip(parts, want):
        got_rows = _port_rows(g)
        want_rows = [(r["ss_sold_date_sk"], r["ss_item_sk"], r["ss_customer_sk"],
                      r["ss_ext_sales_price"]) for r in w]
        assert [r[:2] for r in got_rows] == [r[:2] for r in want_rows]  # the key order
        assert sorted(got_rows, key=repr) == sorted(want_rows, key=repr)


def test_converted_q93_segment_on_the_mesh_equals_the_jax_driver(data):
    jd, pd_ = data
    cust = pd.DataFrame({"c_customer_sk": np.arange(1, 5001, dtype=np.int64),
                         "c_band": np.arange(1, 5001, dtype=np.int64) % 5})
    jres = {"q93_fact": _jax_fact_parts(jd), "q93_cust": [[JBatch.from_pandas(cust)]] * P}
    resp = pt.convert_host_plan(pt.q93_host_plan(P))
    plan = plan_pb2.PhysicalPlanNode.FromString(base64.b64decode(resp["root"]["plan_b64"]))
    jdriver = JDriver(jmake_mesh(P), conf=JConf({"exchange.mode": "mesh"}))
    want = jdriver.run(plan, jres)
    st: dict = {}
    got_q93 = pt.run_q93_converted_mesh(pd_, n_parts=P, device="cpu",
                                        conf={"exchange.mode": "mesh"}, stats=st)
    _assert_q93(got_q93, pt.q93_class_oracle(pd_))
    assert st["mode"] == "mesh" and st["convert_s"] > 0
    np.testing.assert_array_equal(np.array(st["routing"]), np.asarray(jdriver.stats[0].rows))
    got = canon(rows([b for part in pt.run_converted_mesh(
        pt.q93_host_plan(P), pt._q93_resources(pt.ingest_q93(pd_, P, "cpu"), P), P, "cpu",
        {"exchange.mode": "mesh"}) for b in part]))
    want = canon(rows([b for part in want for b in part]))
    key = [r[:3] for r in sorted(got)], [r[:3] for r in sorted(want)]
    assert key[0] == key[1]
    np.testing.assert_allclose([r[3] for r in sorted(got)], [r[3] for r in sorted(want)],
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("mode", ["mesh", "file"])
def test_range_exchange_under_the_mesh_driver(data, mode):
    pd_ = data[1]
    st: dict = {}
    # AQE coalescing off: it would merge the small file-transport partitions
    outs = pt.run_converted_mesh(pt.range_sort_host_plan(pd_, P),
                                 pt.ingest_range_sort(pd_, P, "cpu"), P, "cpu",
                                 {"exchange.mode": mode, "exchange.coalesce.enable": False}, st)
    parts = [pt.collect(o, nulls=True) if o else {} for o in outs]
    assert pt.range_sort_mismatch(parts, pt.range_sort_oracle(pd_)) is None
    assert st["mode"] == mode
    routed = np.array(st["routing"]).sum(axis=0)
    assert routed.tolist() == [len(p["ss_item_sk"]) for p in parts]


def test_the_range_sort_oracle_catches_wrong_answers(data):
    pd_ = data[1]
    parts = pt.run_range_sort_converted(pd_, device="cpu")
    want = pt.range_sort_oracle(pd_)
    assert pt.range_sort_mismatch(parts, want) is None

    def edited(fn):
        out = [{k: v.copy() for k, v in p.items()} for p in parts]
        fn(out)
        return pt.range_sort_mismatch(out, want)

    def swap(out):
        for k in out[1]:
            out[1][k][[0, -1]] = out[1][k][[-1, 0]]

    def move(out):
        for k in out[0]:
            out[0][k] = np.concatenate([out[0][k], out[1][k][:1]])
            out[1][k] = out[1][k][1:]

    def price(out):
        out[2]["ss_ext_sales_price"][5] += 0.01

    def drop(out):
        for k in out[3]:
            out[3][k] = out[3][k][:-1]

    assert "not ordered" in edited(swap)
    assert "bound" in edited(move)
    assert "ss_ext_sales_price differs" in edited(price)
    assert "rows, the fact has" in edited(drop)
