"""The expression tail of the port (``Case``, ``In``, ``Coalesce``,
``Like``) against the JAX ``Evaluator`` on the same batches: numeric and
dictionary-string branches, NULL conditions and arguments, ``In`` negated
and with a NULL item, ``Like`` with ``%``, ``_`` and an escaped wildcard,
and a planner round trip of the four proto variants. Values are compared
where valid (strings decoded through each side's vocabulary), validity
everywhere, all exactly; ``remap_columns`` rebinds every Column that
``walk`` reaches."""

import numpy as np
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import Evaluator as JEval
from auron_tpu.plan import builders as B

from auron_tpu_torch import types as PT
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import Evaluator as PEval
from auron_tpu_torch.plan import planner as pplanner
from torch_carry import carry, jax_batch

N = 600
CATS = np.array(["Books", "Home", "Electronics", "Music", "Sports", "a%b", "a_b", "ab"],
                dtype=object)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    cols = {
        "q": rng.integers(1, 100, N).astype(np.int32),
        "c": rng.integers(-5, 5, N, dtype=np.int64),
        "price": np.round(rng.gamma(2.0, 25.0, N), 2),
        "cat": CATS[rng.integers(0, len(CATS), N)],
        "tag": CATS[rng.integers(0, len(CATS), N)][::-1].copy(),
    }
    valid = {"q": rng.random(N) > 0.1, "c": rng.random(N) > 0.2,
             "cat": rng.random(N) > 0.15, "tag": rng.random(N) > 0.05}
    return jax_batch(cols, valid)


def _exprs(ir, T):
    q, c, price, cat, tag = (ir.col(i) for i in range(5))
    lt = lambda a, b: ir.BinaryOp("lt", a, b)  # noqa: E731
    return {
        "case_numeric": ir.Case(((lt(price, ir.lit(20.0)), ir.lit(0)),
                                 (lt(price, ir.lit(60.0)), ir.lit(1)),
                                 (lt(price, ir.lit(120.0)), ir.lit(2))), ir.lit(3)),
        # NULL conditions (q NULL) count as false; int32 then, int64 else
        "case_null_cond_widen": ir.Case(((lt(q, ir.lit(25)), q),), c),
        "case_no_else": ir.Case(((ir.BinaryOp("gt", c, ir.lit(0)), price),)),
        "case_dict": ir.Case(((lt(q, ir.lit(30)), cat),
                              (lt(q, ir.lit(60)), ir.lit("mid")),
                              (ir.IsNull(c), tag)), ir.Literal(None, T.STRING)),
        "if_dict": ir.If(ir.BinaryOp("gt", price, ir.lit(50.0)), tag, cat),
        "coalesce_numeric": ir.Coalesce((c, q, ir.lit(-1))),
        "coalesce_dict": ir.Coalesce((cat, tag, ir.lit("none"))),
        "in_numeric": ir.In(q, (1, 2, 3, 50, 99)),
        "in_typed_items": ir.In(c, tuple(ir.Literal(v, T.INT32) for v in (-1, 0, 4))),
        "in_negated_null_item": ir.In(c, (1, None, 3), negated=True),
        "in_null_item": ir.In(q, (10, None)),
        "in_float": ir.In(price, (50.0, 12.5)),
        "in_dict": ir.In(cat, ("Books", "Music", "zz")),
        "in_dict_negated_null": ir.In(cat, ("Home", None), negated=True),
        "like_contains": ir.Like(cat, "%o%"),
        "like_underscore": ir.Like(cat, "a_b"),
        "like_escaped_percent": ir.Like(cat, "a\\%%"),
        "like_escaped_underscore": ir.Like(tag, "a!_b", escape="!"),
        "like_negated_prefix": ir.Like(tag, "M%", negated=True),
        "like_in_case": ir.Case(((ir.Like(cat, "%s"), ir.lit(1.5)),), ir.lit(0.0)),
    }


NAMES = tuple(_exprs(pir, PT))


def _decoded(values, validity, d):
    vals = np.asarray(values)
    if d is None:
        return vals[validity]
    entries = d.to_pylist() if hasattr(d, "to_pylist") else list(d)
    return np.array([entries[int(v)] for v in vals[validity]], dtype=object)


def _assert_same(g, w, name):
    assert g.dtype.kind.value == w.dtype.kind.value, (name, g.dtype, w.dtype)
    wm = np.asarray(w.validity)
    np.testing.assert_array_equal(g.validity.numpy(), wm, err_msg=name)
    np.testing.assert_array_equal(_decoded(g.values.numpy(), wm, g.dict),
                                  _decoded(w.values, wm, w.dict), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_expression_matches_reference(name, seed):
    jb = _batch(seed)
    want = JEval(jb.schema).evaluate(jb, [_exprs(jir, JT)[name]])[0]
    pb = carry(jb)
    expr = _exprs(pir, PT)[name]
    got = PEval(pb.schema).evaluate(pb, [expr])[0]
    _assert_same(got, want, name)
    if isinstance(expr, (pir.In, pir.Like)):
        assert got.values.dtype == torch.bool


def test_in_null_rules():
    """Spark: x IN (...) is NULL when x is NULL, or when nothing matched
    and the list holds a NULL; a match is TRUE whatever else the list
    holds."""
    jb = jax_batch({"x": np.array([1, 2, 3], dtype=np.int64)},
                   {"x": np.array([True, True, False])})
    pb = carry(jb)
    got = PEval(pb.schema).evaluate(pb, [pir.In(pir.col(0), (1, None)),
                                         pir.In(pir.col(0), (1, None), negated=True)])
    assert got[0].validity[:3].tolist() == [True, False, False]
    assert got[0].values[:1].tolist() == [True]
    assert got[1].validity[:3].tolist() == [True, False, False]
    assert got[1].values[:1].tolist() == [False]


@pytest.mark.parametrize("name", ["case_numeric", "case_dict", "coalesce_dict",
                                  "in_negated_null_item", "in_dict", "like_escaped_percent",
                                  "like_escaped_underscore"])
def test_planner_round_trip_matches_reference(name):
    """The reference builder's proto of each variant decodes, in the port's
    planner, to the IR the port builds itself, and evaluates like the
    reference's own decode."""
    from auron_tpu.plan import planner as jplanner

    proto = B.expr_to_proto(_exprs(jir, JT)[name])
    port_proto = pplanner._pb().PhysicalExprNode.FromString(proto.SerializeToString())
    decoded = pplanner.expr_from_proto(port_proto)
    want_ir = _exprs(pir, PT)[name]
    if isinstance(want_ir, pir.In):  # the proto carries item values, not Literal nodes
        want_ir = pir.In(want_ir.child, tuple(i.value if isinstance(i, pir.Literal) else i
                                              for i in want_ir.items), want_ir.negated)
    assert decoded == want_ir
    jb = _batch(3)
    want = JEval(jb.schema).evaluate(jb, [jplanner.expr_from_proto(proto)])[0]
    pb = carry(jb)
    _assert_same(PEval(pb.schema).evaluate(pb, [decoded])[0], want, name)


def test_remap_columns_rebinds_every_column():
    e = pir.Case(((pir.BinaryOp("lt", pir.col(4), pir.lit(1)), pir.col(7)),),
                 pir.Coalesce((pir.col(9), pir.In(pir.col(4), (1,)))))
    got = pir.remap_columns(e, {4: 0, 7: 1, 9: 2})
    assert sorted(c.index for c in pir.walk(got) if isinstance(c, pir.Column)) == [0, 0, 1, 2]
    j = jir.Case(((jir.BinaryOp("lt", jir.col(4), jir.lit(1)), jir.col(7)),),
                 jir.Coalesce((jir.col(9), jir.In(jir.col(4), (1,)))))
    want = jir.remap_columns(j, {4: 0, 7: 1, 9: 2})
    assert repr(got).replace("auron_tpu_torch", "auron_tpu") == repr(want)
    assert pir.remap_columns(pir.lit(3), {}) == pir.lit(3)


def test_mixed_dict_and_numeric_branches_are_refused():
    pb = carry(_batch(0))
    with pytest.raises(TypeError, match="mixed"):
        PEval(pb.schema).evaluate(pb, [pir.Coalesce((pir.col(3), pir.col(0)))])
