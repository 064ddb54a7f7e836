"""The port's stage split (``auron_tpu_torch/convert/stages.py``) against
the reference's (``auron_tpu/convert/stages.py``), exact: the same plan
splits into the same stages (ids, exchanges, widths, inputs, plan bytes),
``stage_task`` fills the same paths, ``ffi_reader_ids`` agree, the planner
fills shuffle path templates as the reference's does; the reference's
shuffle manifests read in the port; and a q93 segment split into stages
runs through the port's ``call_native`` on the CPU, equal to its oracle
(keys and counts exact, the price sum at rel 1e-9)."""

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.convert import stages as jstages
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as JB
from auron_tpu.plan import planner as jplanner
from auron_tpu.proto import plan_pb2 as G

from auron_tpu_torch import proto as P
from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.convert import stages as pstages
from auron_tpu_torch.exprs.ir import col
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.plan import builders as PB
from auron_tpu_torch.plan import planner as pplanner

KV = JT.Schema((JT.Field("k", JT.INT64, True), JT.Field("v", JT.FLOAT64, True),
                JT.Field("s", JT.STRING, True)))


def _segment():
    """Two chained exchanges: an ffi_reader's aggregate, then its join with
    another ffi_reader."""
    c = jir.col
    part1 = JB.hash_partitioning([c(0)], 3)
    agg = JB.hash_agg(JB.ffi_reader(KV, "in0"), [(c(0), "k")], [("sum", c(1), "t")], "partial")
    ex1 = JB.mesh_exchange(agg, part1, "")
    fin = JB.hash_agg(ex1, [(c(0), "k")], [("sum", c(1), "t")], "final")
    j = JB.hash_join(fin, JB.ffi_reader(KV, "in1"), [c(0)], [c(0)], "inner")
    ex2 = JB.mesh_exchange(JB.project(j, [(c(0), "k"), (c(1), "t")]),
                           JB.hash_partitioning([c(1)], 2), "ex_b")
    return JB.sort(ex2, [(c(1), JSpec())], fetch=4)


def _det(m) -> bytes:
    return m.SerializeToString(deterministic=True)


@pytest.mark.parametrize("namespace", ["", "q7/"])
def test_split_stages_and_stage_tasks_match_the_reference(namespace, tmp_path):
    plan = _segment()
    port_plan = P.PhysicalPlanNode.FromString(plan.SerializeToString())
    want = jstages.split_stages(plan, namespace)
    got = pstages.split_stages(port_plan, namespace)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.stage_id, g.exchange_id, g.num_output_partitions, g.input_exchange_ids,
                g.is_final, g.data_template, g.index_template) == \
            (w.stage_id, w.exchange_id, w.num_output_partitions, w.input_exchange_ids,
             w.is_final, w.data_template, w.index_template)
        assert g.plan.SerializeToString() == _det(w.plan)
        assert pstages.ffi_reader_ids(g.plan) == jstages.ffi_reader_ids(w.plan)
        for p in range(2):
            conf = {"x": 1, "auron.smj.elide.sorts": "off"}
            assert pstages.stage_task(g, p, str(tmp_path), conf).SerializeToString() == \
                _det(jstages.stage_task(w, p, str(tmp_path), conf))
    assert pstages.ffi_reader_ids(port_plan) == jstages.ffi_reader_ids(plan) == ["in0", "in1"]


def test_shuffle_templates_fill_as_the_reference(tmp_path):
    spec = jstages.split_stages(_segment())[0]
    for conf in ({"auron.work_dir": str(tmp_path)}, {}):
        jt_ = G.TaskDefinition(plan=spec.plan, partition_id=3)
        for k, v in conf.items():
            jt_.conf[k] = v
        pt_ = P.TaskDefinition.FromString(jt_.SerializeToString())
        if not conf:
            with pytest.raises(ValueError, match="auron.work_dir"):
                jplanner._resolve_shuffle_templates(jt_)
            with pytest.raises(ValueError, match="auron.work_dir"):
                pplanner.resolve_shuffle_templates(pt_)
            continue
        jplanner._resolve_shuffle_templates(jt_)
        pplanner.resolve_shuffle_templates(pt_)
        assert pt_.SerializeToString() == _det(jt_)
        assert pt_.plan.shuffle_writer.output_data_file == \
            f"{tmp_path}/__stage_exchange_0_map3.data"


def _run(task, resources):
    out, _ = pt.run_task_bytes(task.SerializeToString(), resources, "cpu")
    return out


def test_q93_segment_in_stages_through_call_native(tmp_path):
    """The q93 plan with a mesh_exchange, split into a map stage and a final
    stage; map tasks from ``stage_task`` bytes, their outputs committed to
    the port's ShuffleManager, read back through the reference's manifest
    format by ``put_resource_shuffle``."""
    d = pt.generate(0.01, 42)
    n_map, n_reduce = 3, 2
    ing = pt.ingest_q93(d, n_map, "cpu")
    plan = pt.q93_reduce_plan(PB.mesh_exchange(pt.q93_map_plan(),
                                               PB.hash_partitioning([col(0)], n_reduce), "q93x"))
    stages = pstages.split_stages(plan)
    assert [s.exchange_id for s in stages] == ["q93x", None]
    shuffle, jshuffle = pstages.ShuffleManager(), jstages.ShuffleManager()
    work = str(tmp_path)
    for p in range(n_map):
        assert _run(pstages.stage_task(stages[0], p, work), {"q93_fact": ing["fact"]}) == []
        paths = (stages[0].data_template.format(work_dir=work, partition=p),
                 stages[0].index_template.format(work_dir=work, partition=p))
        shuffle.register_map_output("q93x", p, *paths)
        jshuffle.register_map_output("q93x", p, *paths)
    assert shuffle.manifest("q93x") == jshuffle.manifest("q93x")
    papi.put_resource_shuffle("q93x", jshuffle.manifest("q93x"))
    try:
        outs = [pt.collect(_run(pstages.stage_task(stages[1], r, work),
                                {"q93_cust": [ing["cust"]] * n_reduce}))
                for r in range(n_reduce)]
    finally:
        papi.remove_resource("q93x")
    got, want = pt._q93_by_key(outs), pt.q93_class_oracle(d)
    assert got["k_null"].tolist() == want["k_null"].tolist()
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)


def test_provider_from_manifest_reads_the_reference_manifest(tmp_path):
    """A manifest the reference's ShuffleManager writes gives the port's
    provider the same files; a missing file raises as the reference's."""
    d = pt.generate(0.005, 3)
    ing = pt.ingest_q93(d, 2, "cpu")
    jm = jstages.ShuffleManager()
    part = PB.hash_partitioning([col(0)], 2)
    for p in range(2):
        files = (str(tmp_path / f"m{p}.data"), str(tmp_path / f"m{p}.index"))
        w = PB.shuffle_writer(pt.q93_map_plan(), part, *files)
        _run(PB.task(w, 1, p), {"q93_fact": ing["fact"]})
        jm.register_map_output("ex", p, *files)
    prov = pstages.provider_from_manifest(jm.manifest("ex"))
    direct = pstages.ShuffleManager()
    for p, (dfile, ifile) in enumerate(jm.map_outputs("ex")):
        direct.register_map_output("ex", p, dfile, ifile)
    for r in range(2):
        assert list(prov.iter_payloads(r)) == list(direct.block_provider("ex").iter_payloads(r))
    bad = jm.manifest("ex").replace(b"m0.data", b"gone.data")
    for reader in (pstages.provider_from_manifest, jstages.provider_from_manifest):
        with pytest.raises(FileNotFoundError):
            reader(bad)
