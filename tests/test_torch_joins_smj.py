"""Slice 5's join operators against auron_tpu: the sort-merge join and the
broadcast hash join (build on the right) for inner, left, left-semi and
left-anti joins, over the build shapes the port prepares (dense table,
duplicate-keyed, NULL probe keys, two packed keys, two keys too wide to
pack, an empty build); the multi-key packing, bit for bit; the union; and
the SMJ input-sort elision rewrite in its three modes on the same protos.
Rows must be equal as sets (every value exact: the joins move values,
they compute none)."""

import numpy as np
import pytest

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.basic import UnionExec as JUnion
from auron_tpu.exec.joins import core as jcore
from auron_tpu.exec.joins.bhj import BroadcastHashJoinExec as JBHJ
from auron_tpu.exec.joins.smj import SortMergeJoinExec as JSMJ
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSortSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import optimizer as joptimizer
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.basic import UnionExec as PUnion
from auron_tpu_torch.exec.joins import core as pcore
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec as PSMJ
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.plan import optimizer as poptimizer
from auron_tpu_torch.plan import planner as pplanner
from torch_carry import canon, carry, jax_batch, rows

JOIN_TYPES = ("inner", "left", "left_semi", "left_anti")
SHAPES = ("lut", "duplicates", "null_keys", "two_keys", "two_keys_wide", "empty_build")


def _case(shape: str, rng):
    """(probe batches, build batch, number of keys) of one build shape."""
    n_keys = 2 if shape.startswith("two_keys") else 1
    if shape == "two_keys_wide":  # full-range keys: more than 63 bits together
        hi = 2**62
        bk0 = rng.integers(-hi, hi, 120, dtype=np.int64)
        bk1 = rng.integers(-hi, hi, 120, dtype=np.int64)
        bk0[60:], bk1[60:] = bk0[:60], bk1[:60]  # every build key twice
        build = jax_batch({"b0": bk0, "b1": bk1, "w": np.arange(120, dtype=np.int64)},
                          {"b1": rng.random(120) > 0.1})
        pick = rng.integers(0, 120, 500)
        k0 = np.where(rng.random(500) < 0.6, bk0[pick], rng.integers(-hi, hi, 500))
        probe = jax_batch({"k0": k0, "k1": bk1[pick], "price": np.round(rng.gamma(2, 25, 500), 2)},
                          {"k0": rng.random(500) > 0.2})
        return [probe], build, n_keys
    if shape == "two_keys":  # (item, date) packed into one word, duplicates
        bi = rng.integers(1, 40, 300, dtype=np.int64)
        bd = rng.integers(2_450_815, 2_450_830, 300).astype(np.int32)
        build = jax_batch({"b0": bi, "b1": bd, "w": rng.integers(0, 9, 300, dtype=np.int64)},
                          {"b0": rng.random(300) > 0.05})
        probes = [jax_batch({"k0": rng.integers(-3, 45, n, dtype=np.int64),
                             "k1": rng.integers(2_450_810, 2_450_835, n).astype(np.int32),
                             "price": np.round(rng.gamma(2, 25, n), 2)},
                            {"k1": rng.random(n) > 0.1}) for n in (700, 300)]
        return probes, build, n_keys
    if shape == "lut":  # unique small dense range: the direct-address table
        bk = np.arange(1, 501, dtype=np.int64)
        build = jax_batch({"b0": bk, "w": bk % 5})
        key_hi, null_share = 700, 0.0
    elif shape == "duplicates":
        bk = rng.integers(1, 300, 600, dtype=np.int64)
        build = jax_batch({"b0": bk, "w": bk % 7}, {"b0": rng.random(600) > 0.1})
        key_hi, null_share = 400, 0.1
    elif shape == "null_keys":  # wide unique build, most probe keys NULL
        bk = rng.choice(np.arange(0, 10**12, 7919, dtype=np.int64), 400, replace=False)
        build = jax_batch({"b0": bk, "w": bk % 3})
        probe = jax_batch({"k0": rng.choice(bk, 600), "price": np.ones(600)},
                          {"k0": rng.random(600) > 0.85})
        return [probe], build, n_keys
    else:  # an empty build
        build = jax_batch({"b0": np.zeros(0, np.int64), "w": np.zeros(0, np.int64)})
        key_hi, null_share = 100, 0.2
    probes = [jax_batch({"k0": rng.integers(0, key_hi, n, dtype=np.int64),
                         "price": np.round(rng.gamma(2.0, 25.0, n), 2)},
                        {"k0": rng.random(n) >= null_share}) for n in (700, 300)]
    return probes, build, n_keys


def _keys(ir, n_keys: int):
    return [ir.col(i) for i in range(n_keys)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("op", ["smj", "bhj"])
def test_join_matches_reference(op, join_type, shape):
    rng = np.random.default_rng(SHAPES.index(shape))
    probes, build, n_keys = _case(shape, rng)
    if op == "smj":
        j = JSMJ(JScan([probes], probes[0].schema), JScan([[build]], build.schema),
                 _keys(jir, n_keys), _keys(jir, n_keys), join_type)
    else:
        j = JBHJ(JScan([probes], probes[0].schema), JScan([[build]], build.schema),
                 _keys(jir, n_keys), _keys(jir, n_keys), join_type, build_side="right")
    want = canon(rows(list(j.execute(0, JCtx(conf=JConf({}))))))
    pprobes, pbuild = [carry(b) for b in probes], carry(build)
    lscan, rscan = PScan([pprobes], pprobes[0].schema), PScan([[pbuild]], pbuild.schema)
    if op == "smj":
        p = PSMJ(lscan, rscan, _keys(pir, n_keys), _keys(pir, n_keys), join_type)
    else:
        p = PBHJ(lscan, rscan, _keys(pir, n_keys), _keys(pir, n_keys), join_type,
                 build_side="right")
    assert p.schema.names == list(j.schema.names)
    got = canon(rows(list(p.execute(0, PCtx(device="cpu")))))
    assert got == want
    n_probe = len(rows(probes))
    if join_type in ("left_semi", "left_anti"):
        assert all(len(r) == len(probes[0].schema) for r in got)
    if join_type == "left_anti":
        # a probe row with a NULL key never matches: anti keeps it
        nulls = sum(any(x is None for x in r[:n_keys]) for r in rows(probes))
        assert sum(any(x is None for x in r[:n_keys]) for r in got) == nulls
    if shape == "empty_build":
        assert len(got) == {"inner": 0, "left": n_probe, "left_semi": 0,
                            "left_anti": n_probe}[join_type]


@pytest.mark.parametrize("projection", [[0, 2], [2]])
@pytest.mark.parametrize("join_type", ["left_semi", "left_anti"])
def test_semi_anti_projection_matches_reference(join_type, projection):
    """The probe-only output subset by the pruning projection."""
    rng = np.random.default_rng(5)
    _, build, _ = _case("duplicates", rng)
    probes = [jax_batch({"k0": rng.integers(0, 400, n, dtype=np.int64),
                         "q": rng.integers(0, 9, n, dtype=np.int64),
                         "price": np.round(rng.gamma(2, 25, n), 2)},
                        {"k0": rng.random(n) > 0.1}) for n in (500, 200)]
    j = JSMJ(JScan([probes], probes[0].schema), JScan([[build]], build.schema),
             [jir.col(0)], [jir.col(0)], join_type, projection=projection)
    want = canon(rows(list(j.execute(0, JCtx(conf=JConf({}))))))
    pprobes, pbuild = [carry(b) for b in probes], carry(build)
    p = PSMJ(PScan([pprobes], pprobes[0].schema), PScan([[pbuild]], pbuild.schema),
             [pir.col(0)], [pir.col(0)], join_type, projection=projection)
    assert p.schema.names == list(j.schema.names)
    assert canon(rows(list(p.execute(0, PCtx(device="cpu"))))) == want


@pytest.mark.parametrize("dtypes", [(np.int64, np.int32), (np.int32, np.int64),
                                    (np.int64, np.int64, np.int32), (np.int64, np.int64)])
def test_multi_key_packing_is_bit_exact(dtypes):
    """The build's PackSpec and every probe row's packed word equal the
    JAX package's; probe keys outside the build's ranges turn invalid."""
    rng = np.random.default_rng(len(dtypes) * 10 + dtypes[0](0).itemsize)
    cols = {f"k{i}": (rng.integers(-50, 50, 400) * (i + 1)).astype(dt)
            for i, dt in enumerate(dtypes)}
    valid = {"k0": rng.random(400) > 0.1}
    bcols = {k: v[:250] for k, v in cols.items()}
    jb, jp = jax_batch(bcols, {"k0": valid["k0"][:250]}), jax_batch(cols, valid)
    keys = [jir.col(i) for i in range(len(dtypes))]
    pkeys = [pir.col(i) for i in range(len(dtypes))]

    jwords, _ = jcore._canon_words(jcore._key_columns(jb, keys))
    jspec = jcore._maybe_pack(jcore._key_columns(jb, keys), jwords,
                              jb.device.sel & jcore._canon_words(jcore._key_columns(jb, keys))[1])
    pb = carry(jb)
    pvals = pcore.key_columns(pb, pkeys)
    pwords, pvalid = pcore.canon_words(pvals)
    pspec = pcore.maybe_pack(pvals, pwords, pb.device.sel & pvalid)
    assert pspec is not None and jspec is not None
    assert (pspec.mins, pspec.maxs, pspec.shifts) == (tuple(jspec.mins), tuple(jspec.maxs),
                                                     tuple(jspec.shifts))

    jw, jv = jcore._canon_words(jcore._key_columns(jp, keys))
    jpacked, jok = jcore._pack_probe_jit(tuple(jw), jv, jspec)
    ppb = carry(jp)
    pw, pv = pcore.canon_words(pcore.key_columns(ppb, pkeys))
    ppacked, pok = pcore.pack_words(pw, pv, pspec)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(pok.numpy(), jok)
    assert 0 < jok.sum() < len(jok)  # some rows out of the build's ranges
    np.testing.assert_array_equal(ppacked.numpy()[jok],
                                  np.asarray(jpacked).view(np.int64)[jok])


def test_packing_refused_like_the_reference():
    """One key, or two keys wider than 63 bits together, do not pack."""
    rng = np.random.default_rng(9)
    for cols in ({"k0": rng.integers(0, 9, 50, dtype=np.int64)},
                 {"k0": rng.integers(-2**62, 2**62, 50, dtype=np.int64),
                  "k1": rng.integers(-2**62, 2**62, 50, dtype=np.int64)}):
        jb = jax_batch(cols)
        keys = [jir.col(i) for i in range(len(cols))]
        jw, jv = jcore._canon_words(jcore._key_columns(jb, keys))
        assert jcore._maybe_pack(jcore._key_columns(jb, keys), jw, jb.device.sel) is None
        pb = carry(jb)
        pv = pcore.key_columns(pb, [pir.col(i) for i in range(len(cols))])
        pw, _ = pcore.canon_words(pv)
        assert pcore.maybe_pack(pv, pw, pb.device.sel) is None


@pytest.mark.parametrize("n_children", [1, 3])
def test_union_matches_reference(n_children):
    rng = np.random.default_rng(n_children)
    parts = [[jax_batch({"i": rng.integers(0, 50, n, dtype=np.int64),
                         "s": rng.random(n)}, {"s": rng.random(n) > 0.2})
              for n in (100, 7)] for _ in range(n_children)]
    j = JUnion([JScan([bs, bs[:1]], bs[0].schema) for bs in parts])
    pparts = [[carry(b) for b in bs] for bs in parts]
    p = PUnion([PScan([bs, bs[:1]], bs[0].schema) for bs in pparts])
    for partition in (0, 1):
        want = rows(list(j.execute(partition, JCtx(conf=JConf({})))))
        got = rows(list(p.execute(partition, PCtx(device="cpu"))))
        assert got == want  # children in turn, each in its own order


# ---- SMJ input-sort elision ----------------------------------------------------


def _fact_schema():
    return jax_batch({"k": np.zeros(1, np.int64), "d": np.zeros(1, np.int64),
                      "v": np.zeros(1, np.float64)}).schema


def _sorted(child, fetch=None):
    return B.sort(child, [(jir.col(0), JSortSpec()), (jir.col(1), JSortSpec())], fetch=fetch)


def _elision_plans():
    s = _fact_schema()
    lscan, rscan = B.memory_scan(s, "l"), B.memory_scan(s, "r")
    keys = [jir.col(0), jir.col(1)]
    plain = B.sort_merge_join(_sorted(lscan), _sorted(rscan), keys, keys, "inner")
    agg = B.hash_agg(plain, [(jir.col(0), "k")], [("count_star", None, "c")], "partial")
    # a limit above the join: its order matters, nothing below is dropped;
    # a fetch sort is never dropped; the union's two joins both rewrite
    limited = B.limit(B.sort_merge_join(_sorted(lscan), _sorted(rscan, fetch=5), keys, keys,
                                        "left_semi"), 10)
    union = B.union([B.sort_merge_join(_sorted(lscan), _sorted(rscan), keys, keys, "left"),
                     B.sort_merge_join(_sorted(lscan, fetch=3), _sorted(rscan), keys, keys,
                                       "left_anti")])
    return {"agg": agg, "limited": limited, "union": union}


def _port_proto(plan):
    return pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())


@pytest.mark.parametrize("which", ["agg", "limited", "union"])
@pytest.mark.parametrize("mode", ["build", "full", "off"])
def test_elide_smj_input_sorts_matches_reference(mode, which):
    plan = _elision_plans()[which]
    want = joptimizer.elide_smj_input_sorts(plan, mode=mode)
    before = _port_proto(plan).SerializeToString()
    got = poptimizer.elide_smj_input_sorts(_port_proto(plan), mode=mode)
    assert got.SerializeToString() == want.SerializeToString()
    assert _port_proto(plan).SerializeToString() == before  # the input is not changed


def _sort_count(op) -> int:
    return (type(op).__name__ == "SortExec") + sum(_sort_count(c) for c in op.children)


@pytest.mark.parametrize("mode,sorts", [(None, 1), ("build", 1), ("full", 0), ("off", 2)])
def test_task_from_proto_elides_by_the_task_conf(mode, sorts):
    """``auron.smj.elide.sorts`` (default build) picks the rewrite before
    pruning and planning, as in the JAX planner."""
    conf = {} if mode is None else {"auron.smj.elide.sorts": mode}
    task = B.task(_elision_plans()["agg"], stage_id=1, partition_id=0, conf=conf)
    ptask = pplanner._pb().TaskDefinition.FromString(task.SerializeToString())
    root, stage, part, pconf = pplanner.task_from_proto(ptask)
    assert (stage, part) == (1, 0) and _sort_count(root) == sorts
    # whole-stage fusion (plan/fusion.py) puts the aggregate's input stage
    # between the aggregate and the join
    below = root.children[0]
    assert type(below).__name__ == "FusedStageExec"
    assert type(below.children[0]).__name__ == "SortMergeJoinExec"


@pytest.mark.parametrize("which", ["agg", "limited", "union"])
def test_prune_columns_over_smj_matches_reference(which):
    """Column pruning through sort-merge joins of every ported type (semi
    and anti joins output the probe side only) and through a union."""
    plan = joptimizer.elide_smj_input_sorts(_elision_plans()[which], mode="full")
    want = joptimizer.prune_columns(plan)
    got = poptimizer.prune_columns(_port_proto(plan))
    assert got.SerializeToString() == want.SerializeToString()
    pplanner.plan_from_proto(got)  # and the port plans it
