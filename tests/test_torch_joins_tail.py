"""The port's join tail against auron_tpu: every join type (inner, left,
right, full, left_semi, left_anti, existence) through the sort-merge join
and the broadcast hash join with the build on either side, residual
conditions, multi-batch string keys, multi-key joins and empty sides (the
matrix of tests/test_joins.py), the 12 seeds of tests/test_join_fuzz.py,
and an empty probe stream under joins that emit build rows. Both packages
get the same numpy inputs; the rows must match exactly, as multisets."""

import numpy as np
import pytest

from auron_tpu.exprs import ir as jir

from auron_tpu_torch import types as T
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exprs import ir as pir
from torch_carry import canon, carry, rows
from torch_joins import batches as _batches, both

KINDS = ("smj", "bhj_right", "bhj_left")
TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti", "existence")


def _ldf():
    return ({"k": np.array([1, 2, 2, 3, 0, 5], np.int64),
             "lv": np.array(["a", "b", "c", "d", "e", "f"], object)},
            {"k": np.array([1, 1, 1, 1, 0, 1], bool)})


def _rdf():
    return ({"k2": np.array([2, 2, 3, 4, 0], np.int64),
             "rv": np.array([20.0, 21.0, 30.0, 40.0, 50.0])},
            {"k2": np.array([1, 1, 1, 1, 0], bool)})


@pytest.mark.parametrize("jt", TYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_matrix_matches_reference(kind, jt):
    got, want = both(kind, _batches(*_ldf(), None), _batches(*_rdf(), None), jt)
    assert got == want
    assert want  # every type answers something on these inputs


@pytest.mark.parametrize("jt", ("left", "right", "full", "left_semi", "left_anti", "existence"))
@pytest.mark.parametrize("kind", KINDS)
def test_condition_matches_reference(kind, jt):
    # rv > 20: the (k=2, rv=20) pair does not count as a match
    def cond(ir):
        return ir.BinaryOp("gt", ir.col(3), ir.Literal(20.0, _float64(ir)))
    got, want = both(kind, _batches(*_ldf(), None), _batches(*_rdf(), None), jt,
                     condition=cond)
    assert got == want


def _float64(ir):
    from auron_tpu import types as JT

    return T.FLOAT64 if ir is pir else JT.FLOAT64


@pytest.mark.parametrize("jt", TYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_string_keys_multibatch(kind, jt):
    rng = np.random.default_rng(11)
    n, m = 500, 300
    left = {"k": rng.choice(np.array(["aa", "bb", "cc", "dd", "ee", "zz"], object), n),
            "lv": rng.integers(0, 1000, n)}
    right = {"k2": rng.choice(np.array(["bb", "cc", "dd", "qq"], object), m),
             "rv": rng.normal(size=m)}
    lvalid = {"k": rng.random(n) > 0.05}
    got, want = both(kind, _batches(left, lvalid, 128), _batches(right, {}, 128), jt)
    assert got == want


@pytest.mark.parametrize("jt", ("inner", "full", "left_semi", "existence"))
@pytest.mark.parametrize("kind", KINDS)
def test_multi_key(kind, jt):
    left = {"a": np.array([1, 1, 2, 2], np.int64),
            "b": np.array(["x", "y", "x", "y"], object), "lv": np.arange(1, 5)}
    right = {"a2": np.array([1, 2, 2], np.int64),
             "b2": np.array(["y", "x", "q"], object), "rv": np.array([10, 20, 30])}
    got, want = both(kind, _batches(left, {}, None), _batches(right, {}, None), jt,
                     lkeys=(0, 1), rkeys=(0, 1))
    assert got == want


@pytest.mark.parametrize("jt", TYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_empty_sides(kind, jt):
    lcols, lvalid = _ldf()
    rcols, rvalid = _rdf()
    empty_l = _batches({k: v[:0] for k, v in lcols.items()}, {}, None)
    empty_r = _batches({k: v[:0] for k, v in rcols.items()}, {}, None)
    for left, right in ((empty_l, _batches(rcols, rvalid, None)),
                        (_batches(lcols, lvalid, None), empty_r)):
        got, want = both(kind, left, right, jt)
        assert got == want


def _fuzz_table(rng, n, key_range, null_frac, names):
    k = rng.integers(0, key_range, n).astype(np.int64)
    return ({names[0]: k, names[1]: rng.integers(0, 1000, n)},
            {names[0]: rng.random(n) >= null_frac})


@pytest.mark.parametrize("seed", range(12))
def test_join_fuzz(seed):
    """tests/test_join_fuzz.py's draws, through both packages."""
    rng = np.random.default_rng(seed + 100)
    left = _fuzz_table(rng, int(rng.integers(0, 120)), int(rng.integers(1, 25)), 0.1, ("k", "p"))
    right = _fuzz_table(rng, int(rng.integers(0, 120)), int(rng.integers(1, 25)), 0.1,
                        ("k2", "q"))
    jt = str(rng.choice(list(TYPES)))
    kind = str(rng.choice(["smj", "bhj_left", "bhj_right"]))
    chunk = int(rng.integers(16, 64))
    got, want = both(kind, _batches(*left, chunk), _batches(*right, chunk), jt)
    assert got == want
    # and every join type and side on the same draw
    for k2 in KINDS:
        for jt2 in TYPES:
            got, want = both(k2, _batches(*left, chunk), _batches(*right, chunk), jt2)
            assert got == want, (k2, jt2)


@pytest.mark.parametrize("jt,side", [("full", "right"), ("full", "left"), ("right", "right"),
                                     ("left", "left"), ("left_semi", "left"),
                                     ("left_anti", "left"), ("existence", "left")])
def test_empty_probe_stream_emits_build_rows(jt, side):
    """A join that emits build rows does so with no probe batch at all: the
    build is prepared before the probe loop."""
    rcols, rvalid = _rdf()
    lcols, lvalid = _ldf()
    build = _batches(lcols, lvalid, None) if side == "left" else _batches(rcols, rvalid, None)
    pbuild = [carry(b) for b in build]
    other = _batches(rcols, rvalid, None) if side == "left" else _batches(lcols, lvalid, None)
    pschema = carry(other[0]).schema
    probe = PScan([[]], pschema)
    bscan = PScan([pbuild], pbuild[0].schema)
    left, right = (bscan, probe) if side == "left" else (probe, bscan)
    op = PBHJ(left, right, [pir.col(0)], [pir.col(0)], jt, build_side=side)
    got = canon(rows(list(op.execute(0, PCtx(device="cpu")))))
    n_build = len(rows(build))
    if jt == "left_semi":
        assert got == []
    else:
        assert len(got) == n_build
        if jt == "existence":
            assert all(r[-1] is False for r in got)


def test_existence_column_name_from_proto():
    """The planner passes the hash join's and the sort-merge join's
    ``exists_col`` through (reference planner.py:392,406)."""
    from auron_tpu.plan import builders as B
    from auron_tpu_torch.plan.planner import plan_from_proto

    lcols, lvalid = _ldf()
    schema = carry(_batches(lcols, lvalid, None)[0]).schema
    proto_schema = _proto_schema(schema)
    for make, field in ((B.hash_join, "hash_join"), (B.sort_merge_join, "sort_merge_join")):
        node = make(B.memory_scan(proto_schema, "l"), B.memory_scan(proto_schema, "r"),
                    [jir.col(0)], [jir.col(0)], "existence")
        getattr(node, field).exists_col = "has_match"
        op = plan_from_proto(node)
        assert op.schema.names[-1] == "has_match"
        assert op.schema[-1].dtype == T.BOOL


def _proto_schema(schema):
    from auron_tpu import types as JT

    return JT.Schema(tuple(JT.Field(f.name, JT.DataType(JT.TypeKind(f.dtype.kind.value),
                                                        f.dtype.precision, f.dtype.scale),
                                    f.nullable) for f in schema))
