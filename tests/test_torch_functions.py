"""The scalar-function registry of the port (``auron_tpu_torch/functions/``)
against the reference's (``auron_tpu/functions/``), on the same batch: one
case per ported name, each through both packages' ``Evaluator`` over
``ScalarFunc`` nodes, with NULLs, empty strings, negative dates and
timestamps, NaN, +-inf and +-0.0 among the values. Results are compared
bit for bit (values where valid, validity everywhere, dictionaries by the
decoded entries), except the float functions of ``TRANSCENDENTAL``,
compared at rel 1e-12 with results below the smallest normal float64
taken as zero: torch's libm and XLA's differ in the last bits (torch's CPU
``sqrt`` too: it gives 0x1.6a09e667f3bccp-1 for sqrt(0.5), one ulp below
the correctly rounded value, which XLA and CUDA give), and XLA flushes
subnormal results to zero (``exp(-710)``), which torch and Spark do not
(ROADMAP Queue 3).

Also: the names (the reference's; the MAP/STRUCT ones have their parity
cases in tests/test_torch_nested.py, which run since ROADMAP Queue 1 item
2), the Spark hash vectors of
tests/test_hashing.py through ``hash``/``xxhash64`` and the port's
``hash_batch``, the hash kernels at every fixed type against the
reference's, and bloom filters serialized by one package and read by the
other."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import Evaluator as JEval
from auron_tpu.functions import registry as jreg
from auron_tpu.ops import hashing as jh
from auron_tpu.ops.bloom import SparkBloomFilter as JBloom
from auron_tpu.ops.hash_dispatch import hash_batch as jhash_batch

from auron_tpu_torch import types as PT
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import Evaluator as PEval
from auron_tpu_torch.functions import registry as preg
from auron_tpu_torch.ops import hashing as ph
from auron_tpu_torch.ops.bloom import SparkBloomFilter as PBloom
from auron_tpu_torch.ops.hash_dispatch import hash_batch as phash_batch
import torch_function_cases as C
from torch_carry import carry, rows

TRANSCENDENTAL = frozenset({"sqrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan", "asin",
                            "acos", "atan", "sinh", "cosh", "tanh", "cbrt", "pow", "atan2"})
RTOL = 1e-12  # the transcendental functions: torch's libm against XLA's
ATOL = np.finfo(np.float64).tiny  # XLA flushes subnormal results to zero

FRAME = C.host_frame()


def _arrow(name: str) -> pa.Array:
    v, m = FRAME[name]
    kind = C.KINDS[name]
    if kind == "dec":
        return pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in v],
                        type=pa.decimal128(10, 2), mask=~m)
    typ = C.port_dtype(kind, JT).to_arrow()
    if isinstance(v, list):
        return pa.array([x if ok else None for x, ok in zip(v, m)], type=typ)
    if kind == "date":
        return pa.array(v, mask=~m).cast(pa.date32())
    if kind == "ts":
        return pa.array(v, mask=~m).cast(pa.timestamp("us"))
    return pa.array(v, mask=~m)


JB = JBatch.from_arrow(pa.RecordBatch.from_arrays([_arrow(n) for n in C.KINDS],
                                                  names=list(C.KINDS)))
PB = carry(JB)
COL = C.COL


def _bloom_bytes() -> bytes:
    import jax.numpy as jnp

    bf = JBloom.create(200, 0.05)
    bf.put_long(jnp.asarray(C.bloom_values()))
    return bf.serialize()


BLOOM = _bloom_bytes()


def _cases(ir, T):
    return C.cases(ir, T, BLOOM)


PORTED = sorted(_cases(pir, PT))


def _dtype_sig(t):
    return (t.kind.value, t.precision, t.scale, tuple(_dtype_sig(i) for i in t.inner))


def _same_floats(g, w, rtol: float | None) -> bool:
    nan = np.isnan(g) & np.isnan(w)
    if (np.isnan(g) != np.isnan(w)).any():
        return False
    if rtol is None:
        iv = np.int32 if g.dtype == np.float32 else np.int64
        return bool((g.view(iv) == w.view(iv))[~nan].all())
    fin = np.isfinite(w) & ~nan
    if not (g[~fin & ~nan] == w[~fin & ~nan]).all():
        return False
    return bool(np.allclose(g[fin], w[fin], rtol=rtol, atol=ATOL))


def _assert_same(name: str, got, want, rtol) -> None:
    assert _dtype_sig(got.dtype) == _dtype_sig(want.dtype), (name, got.dtype, want.dtype)
    gv, gm, ge = C.host_result(got)
    wv, wm, we = C.host_result(want)
    np.testing.assert_array_equal(gm, wm, err_msg=f"{name}: validity")
    if we is not None:
        gd, wd = C.decoded(gv, gm, ge), C.decoded(wv, wm, we)
        assert gd == wd, (name, [(a, b) for a, b in zip(gd, wd) if a != b][:5])
        return
    g, w = gv[gm], wv[wm]
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        assert _same_floats(g, w, rtol), (name, g[:8], w[:8])
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)


def _eval_both(name: str, args_j, args_p):
    je = JEval(JB.schema).evaluate(JB, [jir.ScalarFunc(name, tuple(args_j))])[0]
    pe = PEval(PB.schema).evaluate(PB, [pir.ScalarFunc(name, tuple(args_p))])[0]
    return pe, je


def test_the_frame_ingests_alike_in_both_packages():
    """``Batch.from_numpy`` of the host frame (LIST columns with lists of
    equal length among them) holds the rows the reference ingests from
    Arrow (carried over plane for plane)."""
    def nan_free(rs):
        return [tuple("nan" if isinstance(x, float) and x != x else x for x in r) for r in rs]

    assert nan_free(rows([C.port_batch(FRAME, "cpu")])) == nan_free(rows([PB]))


def test_names_are_the_reference_minus_map_and_struct():
    """Every name of the reference is registered; the MAP and STRUCT ones
    have their parity cases in tests/test_torch_nested.py, every other
    name a case below."""
    ref = set(jreg.names())
    assert len(ref) == 124
    assert set(C.NESTED_FUNCTIONS) <= ref and len(C.NESTED_FUNCTIONS) == 9
    assert set(preg.names()) == ref
    assert sorted(set(preg.names()) - set(C.NESTED_FUNCTIONS)) == PORTED


_MAP = PT.DataType(PT.TypeKind.MAP, inner=(PT.STRING, PT.INT64))
_JMAP = JT.DataType(JT.TypeKind.MAP, inner=(JT.STRING, JT.INT64))


def _nested_arg_types(T, m):
    """Argument types of a call of each MAP/STRUCT function."""
    lst = lambda t: T.DataType(T.TypeKind.LIST, inner=(t,))  # noqa: E731
    entry = T.DataType(T.TypeKind.STRUCT, inner=(T.STRING, T.INT64), struct_names=("key", "value"))
    st = T.DataType(T.TypeKind.STRUCT, inner=(T.INT64, T.STRING), struct_names=("x", "s"))
    return {"get_map_value": [m, T.STRING], "map_concat": [m, m],
            "map_from_arrays": [lst(T.STRING), lst(T.INT64)], "map_from_entries": [lst(entry)],
            "map_keys": [m], "map_values": [m], "str_to_map": [T.STRING],
            "named_struct": [T.STRING, T.INT64], "get_struct_field": [st, T.STRING]}


@pytest.mark.parametrize("name", C.NESTED_FUNCTIONS)
def test_map_and_struct_functions_raise_naming_their_item(name):
    """Each MAP/STRUCT function (ROADMAP Queue 1 item 2) is registered, no
    longer raises at dispatch, and its planner type is the reference's."""
    assert preg.lookup(name) is not None
    got = preg.infer_dtype(name, _nested_arg_types(PT, _MAP)[name])
    want = jreg.infer_dtype(name, _nested_arg_types(JT, _JMAP)[name])
    assert _dtype_sig(got) == _dtype_sig(want)


def test_element_at_over_a_map_raises_naming_its_item():
    """element_at over a MAP (ROADMAP Queue 1 item 2) runs: the value of
    the key, NULL where the map lacks it or the row is NULL."""
    from auron_tpu_torch.exprs.eval import ColumnVal

    vocab = np.empty(3, dtype=object)
    vocab[:] = [[("a", 1), ("b", 2)], [("b", 3)], []]
    cv = ColumnVal(torch.tensor([0, 1, 2, 0], dtype=torch.int32),
                   torch.tensor([True, True, True, False]), _MAP, vocab)
    key = ColumnVal(torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                    PT.STRING, np.array(["b"], dtype=object), const="b")
    out = preg.dispatch("element_at", [cv, key], 4, "cpu")
    assert out.dtype == PT.INT64
    assert out.values[out.validity].tolist() == [2, 3]
    assert out.validity.tolist() == [True, True, False, False]


@pytest.mark.parametrize("name", PORTED)
def test_function_matches_the_reference(name):
    cj, cp = _cases(jir, JT)[name], _cases(pir, PT)[name]
    rtol = RTOL if name in TRANSCENDENTAL else None
    for aj, ap in zip(cj, cp):
        got, want = _eval_both(name, aj, ap)
        _assert_same(f"{name}{tuple(str(a) for a in ap)}", got, want, rtol)
        # the dtype the planner infers is the one the kernel returns
        assert _dtype_sig(pir.ScalarFunc(name, tuple(ap)).dtype_of(PB.schema)) == _dtype_sig(
            jir.ScalarFunc(name, tuple(aj)).dtype_of(JB.schema))


def test_float_edge_rules():
    """The jnp rules the registry spells out: signum keeps NaN and -0.0,
    cbrt is sign-preserving through -0.0, +-inf and NaN, float -> int64
    saturates with NaN -> 0, round is HALF_UP and bround HALF_EVEN."""
    import jax.numpy as jnp

    from auron_tpu_torch.functions.registry import _cbrt, _signum, f64_to_i64

    x = np.array([-0.0, 0.0, np.nan, -np.inf, np.inf, -27.0, 8.0, 1e-300, -3.5, 1e19, -1e19])
    t = torch.from_numpy(x)
    assert _same_floats(_signum(t).numpy(), np.asarray(jnp.sign(x)), None)
    assert np.isnan(_signum(t).numpy()[2]) and np.signbit(_signum(t).numpy()[0])
    assert _same_floats(_cbrt(t).numpy(), np.asarray(jnp.cbrt(x)), RTOL)
    assert np.signbit(_cbrt(t).numpy()[0]) and np.isnan(_cbrt(t).numpy()[2])
    np.testing.assert_array_equal(f64_to_i64(torch.ceil(t)).numpy(),
                                  np.asarray(jnp.ceil(x).astype(jnp.int64)))


def test_wide_decimal_arguments_are_refused_except_by_the_safe_functions():
    wide = pa.array([decimal.Decimal("1.5"), None], type=pa.decimal128(30, 4))
    jb = JBatch.from_arrow(pa.RecordBatch.from_arrays([wide], names=["w"]))
    pb = carry(jb)
    with pytest.raises(NotImplementedError, match="decimal"):
        PEval(pb.schema).evaluate(pb, [pir.ScalarFunc("abs", (pir.col(0),))])
    got = PEval(pb.schema).evaluate(pb, [pir.ScalarFunc("xxhash64", (pir.col(0),))])[0]
    want = JEval(jb.schema).evaluate(jb, [jir.ScalarFunc("xxhash64", (jir.col(0),))])[0]
    _assert_same("xxhash64(wide)", got, want, None)


# ---------------------------------------------------------------------------
# Spark's hash vectors (tests/test_hashing.py) and the hash kernels
# ---------------------------------------------------------------------------


def _i32(vals):
    return [v - (1 << 32) if v >= (1 << 31) else v for v in vals]


SPARK_VECTORS = [
    ("hash", pa.array([1, 2, 3, 4], type=pa.int32()),
     [-559580957, 1765031574, -1823081949, -397064898]),
    ("hash", pa.array([1, 0, -1, 127, -128], type=pa.int8()),
     _i32([0xDEA578E3, 0x379FAE8F, 0xA0590E3D, 0x43B4D8ED, 0x422A1365])),
    ("murmur3_hash", pa.array([1, 0, -1, 2**63 - 1, -(2**63)], type=pa.int64()),
     _i32([0x99F0149D, 0x9C67B85D, 0xC8008529, 0xA05B5D7B, 0xCD1E64FB])),
    ("hash", pa.array(["hello", "bar", "", "😁", "天地"]),
     _i32([3286402344, 2486176763, 142593372, 885025535, 2395000894])),
    ("xxhash64", pa.array([1, 0, -1, 2**63 - 1, -(2**63)], type=pa.int64()),
     [-7001672635703045582, -5252525462095825812, 3858142552250413010,
      -3246596055638297850, -8619748838626508300]),
    ("xxhash64", pa.array(["hello", "bar", "", "😁", "天地"]),
     [-4367754540140381902, -1798770879548125814, -7444071767201028348,
      -6337236088984028203, -235771157374669727]),
    ("hash", pa.array([None, 1], type=pa.int32()), [42, -559580957]),
]


@pytest.mark.parametrize("case", range(len(SPARK_VECTORS)))
def test_spark_hash_vectors(case):
    name, arr, want = SPARK_VECTORS[case]
    jb = JBatch.from_arrow(pa.RecordBatch.from_arrays([arr], names=["x"]))
    pb = carry(jb)
    got = PEval(pb.schema).evaluate(pb, [pir.ScalarFunc(name, (pir.col(0),))])[0]
    assert got.values.numpy()[: len(arr)].tolist() == want
    algo = "xxhash64" if name == "xxhash64" else "murmur3"
    assert phash_batch(pb, [0], algo).numpy()[: len(arr)].tolist() == want


def test_long_strings_xxhash64_match_the_reference():
    """Strings past 32 bytes take the four-accumulator stripe path."""
    strings = ["a" * 31, "b" * 32, "c" * 33, "d" * 64, "e" * 100, "xyz" * 17, "ü" * 40, None]
    jb = JBatch.from_arrow(pa.RecordBatch.from_arrays([pa.array(strings)], names=["s"]))
    for algo in ("xxhash64", "murmur3"):
        want = np.asarray(jhash_batch(jb, [0], algo))
        np.testing.assert_array_equal(phash_batch(carry(jb), [0], algo).numpy(), want)


@pytest.mark.parametrize("fn", ["murmur3_f32", "murmur3_f64", "murmur3_i128_from_i64",
                                "xxhash64_i32", "xxhash64_f32", "xxhash64_f64",
                                "xxhash64_i128_from_i64", "xxhash64_i64"])
def test_hash_kernels_match_the_reference(fn):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    if "f32" in fn or "f64" in fn:
        v = rng.normal(0, 1e6, 500)
        v[:6] = (0.0, -0.0, np.nan, np.inf, -np.inf, 1e-310)
        v = v.astype(np.float32) if "f32" in fn else v
    elif "i32" in fn:
        v = rng.integers(-(2**31), 2**31, 500).astype(np.int32)
    else:
        v = rng.integers(-(2**63), 2**63 - 1, 500, dtype=np.int64)
    seeds = rng.integers(0, 2**31, 500).astype(np.int64)
    if fn.startswith("murmur3"):
        want = np.asarray(getattr(jh, fn)(jnp.asarray(v), jnp.asarray(seeds.astype(np.uint32))))
        got = getattr(ph, fn)(torch.from_numpy(v), torch.from_numpy(seeds)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        want = np.asarray(getattr(jh, fn)(jnp.asarray(v), jnp.asarray(seeds.astype(np.uint64))))
        got = getattr(ph, fn)(torch.from_numpy(v), torch.from_numpy(seeds)).numpy()
        np.testing.assert_array_equal(got.view(np.uint64), want)


def test_hash_batch_xxhash64_every_column_type_chains_like_the_reference():
    cols = [COL[n] for n in ("i32", "i64", "f64", "f32", "s", "d", "ts", "dec", "b", "num")]
    for algo in ("xxhash64", "murmur3"):
        want = np.asarray(jhash_batch(JB, cols, algo, seed=7))
        np.testing.assert_array_equal(phash_batch(PB, cols, algo, seed=7).numpy(), want)


# ---------------------------------------------------------------------------
# bloom filters across the packages
# ---------------------------------------------------------------------------


def test_bloom_filter_bytes_read_both_ways():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    items = rng.integers(-(2**50), 2**50, 3000, dtype=np.int64)
    probes = np.concatenate([items[:500], rng.integers(-(2**50), 2**50, 4000, dtype=np.int64)])
    jb = JBloom.create(3000, 0.03)
    jb.put_long(jnp.asarray(items))
    pb = PBloom.create(3000, 0.03, device="cpu")
    pb.put_long(torch.from_numpy(items))
    assert (pb.num_bits, pb.num_hashes) == (jb.num_bits, jb.num_hashes)
    # the same bytes from either package
    assert pb.serialize() == jb.serialize()
    want = np.asarray(jb.might_contain_long(jnp.asarray(probes)))
    assert want[:500].all()  # no false negatives
    # the reference's bytes read by the port, the port's read by the reference
    got = PBloom.deserialize(jb.serialize(), device="cpu").might_contain_long(torch.from_numpy(probes))
    np.testing.assert_array_equal(got.numpy(), want)
    back = JBloom.deserialize(pb.serialize()).might_contain_long(jnp.asarray(probes))
    np.testing.assert_array_equal(np.asarray(back), want)


def test_bloom_filter_defaults_to_the_card():
    """Without a device a new or read filter goes to the card: on a box
    without one it raises as ``resolve_device`` does; ``device="cpu"`` is
    the caller's explicit choice. With a card present the default is held
    in ``tests/test_torch_cuda.py``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract is exercised elsewhere")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PBloom.create(1000, 0.03)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PBloom(4096, 3)
    cpu = PBloom.create(1000, 0.03, device="cpu")
    assert cpu.words.device.type == "cpu"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PBloom.deserialize(cpu.serialize())
    back = PBloom.deserialize(cpu.serialize(), device="cpu")
    assert back.serialize() == cpu.serialize()


def test_bloom_put_skips_invalid_rows_and_merges():
    items = torch.arange(0, 1000, dtype=torch.int64) * 7919
    valid = torch.arange(1000) % 3 != 0
    a = PBloom(4096, 3, device="cpu")
    a.put_long(items, valid)
    hit = a.might_contain_long(items)
    assert hit[valid].all()
    b = PBloom(4096, 3, device="cpu")
    b.put_long(items[~valid])
    assert a.merge(b).might_contain_long(items).all()
