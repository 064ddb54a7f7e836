"""The port's ``plan/explain.py`` against the reference's: for the same plan
proto, ``explain`` of the port's planned tree equals the JAX ``explain`` of
the JAX planner's tree after ``normalize``, and ``explain_proto`` of the
port's message equals the reference's of the reference message (exact
text); ``check_stability`` writes a golden and refuses a changed plan."""

import pytest

from auron_tpu import types as JT
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as JB
from auron_tpu.plan import explain as jexplain
from auron_tpu.plan import optimizer as joptimizer
from auron_tpu.plan import planner as jplanner

from auron_tpu_torch import proto as P
from auron_tpu_torch.plan import explain as pexplain
from auron_tpu_torch.plan import planner as pplanner

KV = JT.Schema((JT.Field("k", JT.INT64, True), JT.Field("v", JT.FLOAT64, False),
                JT.Field("s", JT.STRING, True)))


def _plans() -> dict:
    """Reference plan protos of every operator the port plans."""
    col, lit = jir.col, jir.lit
    leaf = JB.memory_scan(KV, "src")
    right = JB.memory_scan(KV, "dim")
    part = JB.hash_partitioning([col(0)], 4)
    agg = JB.hash_agg(JB.filter_(leaf, [jir.IsNotNull(col(0))]), [(col(2), "s")],
                      [("sum", col(1), "t"), ("count_star", None, "n")], "partial")
    return {
        "project_filter": JB.project(JB.filter_(leaf, [jir.BinaryOp("gt", col(1), lit(0.5))]),
                                     [(jir.BinaryOp("mul", col(0), lit(2)), "k2"),
                                      (jir.Like(col(2), "a%"), "like"),
                                      (jir.In(col(0), (1, 2)), "in")]),
        "agg_sort_limit": JB.limit(JB.sort(JB.hash_agg(agg, [(col(0), "s")],
                                                       [("sum", col(1), "t"),
                                                        ("count_star", None, "n")], "final"),
                                           [(col(1), JSpec(asc=False))], fetch=5), 3),
        "hash_join": JB.project(JB.hash_join(leaf, right, [col(0)], [col(0)], "left",
                                             cached_build_id="b"),
                                [(col(1), "v"), (col(5), "s2")]),
        "smj": JB.sort_merge_join(JB.sort(leaf, [(col(0), JSpec())]),
                                  JB.sort(right, [(col(0), JSpec())]), [col(0)], [col(0)],
                                  "inner", jir.BinaryOp("lt", col(1), col(4))),
        "window": JB.window(leaf, [col(2)], [(col(1), JSpec())],
                            [("rank", None, None, 1, False, "r"),
                             ("agg", "sum", col(1), 0, True, "w")]),
        "expand_union": JB.union([JB.expand(leaf, [[col(0), col(1)], [col(0), lit(0.0)]],
                                            ["k", "v"]),
                                  JB.project(right, [(col(0), "k"), (col(1), "v")])]),
        "generate": JB.generate(JB.project(leaf, [(jir.ScalarFunc("split", (col(2), lit(","))),
                                                   "parts"), (col(0), "k")]),
                                "explode", col(0), [1], outer=True),
        "shuffle": JB.shuffle_writer(JB.coalesce_batches(JB.debug(leaf, "d"), 64), part,
                                     "/tmp/w/x_map0.data", "/tmp/w/x_map0.index"),
        "ipc": JB.ipc_writer(JB.rename_columns(JB.ipc_reader(KV, "ex0"), ["a", "b", "c"]), "o"),
        "empty_ffi": JB.union([JB.empty_partitions(KV, 2), JB.ffi_reader(KV, "in")]),
    }


@pytest.mark.parametrize("name", sorted(_plans()))
def test_explain_matches_the_reference(name):
    plan = _plans()[name]
    port = P.PhysicalPlanNode.FromString(plan.SerializeToString())
    want = jplanner.plan_from_proto(joptimizer.prune_columns(
        joptimizer.elide_smj_input_sorts(plan)))
    got = pplanner.tree_from_plan(port)
    assert pexplain.normalize(pexplain.explain(got)) == jexplain.normalize(jexplain.explain(want))
    assert pexplain.explain_proto(port) == jexplain.explain_proto(plan)


def test_explain_proto_of_plans_the_planners_do_not_run():
    """Scans, sinks and exchanges the port's planner refuses, and the mesh
    exchange the reference's planner leaves to its driver, still render."""
    leaf = JB.memory_scan(KV, "src")
    part = JB.hash_partitioning([jir.col(0)], 4)
    plans = [JB.hash_agg(JB.mesh_exchange(leaf, part, "ex1"), [(jir.col(0), "k")],
                         [("sum", jir.col(1), "t")], "final"),
             JB.parquet_scan(KV, ["/d/a.parquet", "/d/b.parquet"], [], "fs"),
             JB.parquet_sink(leaf, "/out/t", {"k": "v"}, ["s"]),
             JB.rss_shuffle_writer(leaf, JB.hash_partitioning([jir.col(0)], 3), "rss"),
             JB.kafka_scan(KV, "t", "src", start_offsets={0: 5}),
             JB.hash_join(leaf, leaf, [jir.col(0)], [jir.col(0)], "inner")]
    plans[-1].hash_join.projection.extend([0, 4])
    plans[-1].hash_join.has_projection = True
    for plan in plans:
        port = P.PhysicalPlanNode.FromString(plan.SerializeToString())
        assert pexplain.explain_proto(port) == jexplain.explain_proto(plan)
        assert pexplain.normalize(pexplain.explain_proto(port)) == \
            jexplain.normalize(jexplain.explain_proto(plan))


def test_every_plan_variant_has_details():
    variants = [f.name for f in P.PhysicalPlanNode.DESCRIPTOR.oneofs_by_name["plan"].fields]
    assert sorted(pexplain.PLAN_DETAILS) == sorted(variants)
    assert pexplain.PLAN_DETAILS == jexplain.PLAN_DETAILS


def test_check_stability(tmp_path):
    plans = _plans()
    golden = str(tmp_path / "g" / "plan.txt")
    tree = pplanner.tree_from_plan(P.PhysicalPlanNode.FromString(
        plans["shuffle"].SerializeToString()))
    pexplain.check_stability(tree, golden)  # writes the golden
    pexplain.check_stability(tree, golden)  # and holds to it
    text = "shuffle_writer /tmp/w/x_map0.data resource_id=ex7"
    assert pexplain.normalize(text) == jexplain.normalize(text) == \
        "shuffle_writer <path> resource_id=<id>"
    other = pplanner.tree_from_plan(P.PhysicalPlanNode.FromString(
        plans["agg_sort_limit"].SerializeToString()))
    with pytest.raises(AssertionError, match="plan changed"):
        pexplain.check_stability(other, golden)
