"""Range partitioning: the port's ``RangePartitioning``,
``make_range_bounds`` and the converters' ``_range_partitioning_proto``
against the reference's.

- ``partition_ids`` equal the reference's bit for bit on seeded batches of
  int64, int32, float64 (NaN, +-0.0, +-inf), date and decimal64 keys with
  NULLs, ascending and descending, NULLs first and last, 1 to 3 keys and 1
  to 16 partitions, over bounds the reference's ``make_range_bounds`` drew
  from a sample of the same batch (so rows equal to a bound occur);
- ``make_range_bounds`` equals the reference's on those samples;
- ``_range_partitioning_proto`` gives the reference's words (and the same
  message bytes) from typed literal bound rows, with pyarrow unimportable
  for the port's call, and refuses string keys, missing bounds and a
  decimal bound shipped as a string as the reference does.
"""

import decimal
import sys

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.convert import converters as jconverters
from auron_tpu.exec.shuffle.partitioning import RangePartitioning as JRange
from auron_tpu.exec.shuffle.partitioning import make_range_bounds as jmake_bounds
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.convert import converters as pconverters
from auron_tpu_torch.exec.shuffle.partitioning import RangePartitioning as PRange
from auron_tpu_torch.exec.shuffle.partitioning import make_range_bounds as pmake_bounds
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.utils.config import Configuration as PConf

from torch_carry import carry

KINDS = ("int64", "int32", "float64", "date", "decimal")
_SPECIALS = [float("nan"), -0.0, 0.0, float("inf"), float("-inf"), 1.5, -1.5]


def _column(rng, kind: str, n: int) -> pa.Array:
    mask = rng.random(n) < 0.15
    if kind == "int64":
        v = rng.integers(-40, 40, n)
        v[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
        return pa.array(v, type=pa.int64(), mask=mask)
    if kind == "int32":
        v = rng.integers(-40, 40, n).astype(np.int32)
        v[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        return pa.array(v, type=pa.int32(), mask=mask)
    if kind == "float64":
        v = np.where(rng.random(n) < 0.4, rng.choice(_SPECIALS, n),
                     np.round(rng.normal(0, 10, n), 1))
        return pa.array(v, type=pa.float64(), mask=mask)
    if kind == "date":
        return pa.array(rng.integers(18000, 18030, n).astype(np.int32), type=pa.date32(),
                        mask=mask)
    vals = [None if m else decimal.Decimal(int(x)).scaleb(-2)
            for x, m in zip(rng.integers(-5000, 5000, n), mask)]
    return pa.array(vals, type=pa.decimal128(9, 2))


def _case(seed: int):
    rng = np.random.default_rng(seed)
    n_keys = 1 + seed % 3
    kinds = [KINDS[(seed + i) % len(KINDS)] for i in range(n_keys)]
    n = int(rng.integers(200, 700))
    rb = pa.RecordBatch.from_arrays([_column(rng, k, n) for k in kinds] +
                                    [pa.array(np.arange(n, dtype=np.int64))],
                                    names=[f"k{i}" for i in range(n_keys)] + ["row"])
    specs = [(bool(rng.integers(2)), bool(rng.integers(2))) for _ in range(n_keys)]
    n_parts = [1, 2, 3, 4, 5, 7, 8, 16][seed % 8]
    return rb, specs, n_parts


SEEDS = list(range(24))


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_ids_and_bounds_equal_the_reference(seed):
    rb, specs, n_parts = _case(seed)
    jb = JBatch.from_arrow(rb)
    pbatch = carry(jb)
    n_keys = len(specs)
    jexprs, pexprs = [jir.col(i) for i in range(n_keys)], [pir.col(i) for i in range(n_keys)]
    jspecs = [JSpec(asc=a, nulls_first=nf) for a, nf in specs]
    pspecs = [PSpec(asc=a, nulls_first=nf) for a, nf in specs]
    # bounds from a sample: every third row of the batch
    sample = rb.take(pa.array(np.arange(0, rb.num_rows, 3)))
    jbounds = jmake_bounds(JBatch.from_arrow(sample), jexprs, jspecs, n_parts)
    pbounds = pmake_bounds(carry(JBatch.from_arrow(sample)), pexprs, pspecs, n_parts)
    assert pbounds.dtype == np.uint64 and pbounds.shape == jbounds.shape
    np.testing.assert_array_equal(pbounds, jbounds)
    want = np.asarray(JRange(jexprs, jspecs, n_parts, jbounds).partition_ids(jb, None))
    got = PRange(pexprs, pspecs, n_parts, pbounds).partition_ids(pbatch, None)
    np.testing.assert_array_equal(got.numpy(), want)
    live = got.numpy()[: rb.num_rows]
    assert live.min() >= 0 and live.max() <= n_parts - 1
    if n_parts > 1:
        assert len(np.unique(live)) > 1  # the bounds do split the batch


@pytest.mark.parametrize("n_parts", [2, 5])
def test_partition_ids_at_bound_words_with_the_top_bit_set(n_parts):
    """Bound words past 2^63 (descending keys invert their words) compare
    unsigned, as the reference's uint64 words do."""
    rb = pa.RecordBatch.from_arrays([pa.array(np.arange(-20, 20, dtype=np.int64))], names=["k"])
    jb = JBatch.from_arrow(rb)
    for asc in (True, False):
        jspecs, pspecs = [JSpec(asc=asc, nulls_first=False)], [PSpec(asc=asc, nulls_first=False)]
        jbounds = jmake_bounds(jb, [jir.col(0)], jspecs, n_parts)
        assert (jbounds[:, 1] >= np.uint64(1 << 63)).any() or asc
        want = np.asarray(JRange([jir.col(0)], jspecs, n_parts, jbounds).partition_ids(jb, None))
        got = PRange([pir.col(0)], pspecs, n_parts, jbounds).partition_ids(carry(jb), None)
        np.testing.assert_array_equal(got.numpy(), want)


def _fields(order):
    return [{"expr": {"kind": "attr", "index": i}, "asc": asc, "nulls_first": nf}
            for i, (asc, nf) in enumerate(order)]


BOUND_CASES = {
    "long": ([(True, True)], [[{"value": 10, "type": "long"}], [{"value": None, "type": "long"}],
                              [{"value": -(2**63), "type": "long"}]]),
    "int_desc": ([(False, False)], [[{"value": 7, "type": "int"}],
                                    [{"value": 2.0, "type": "int"}]]),
    "double": ([(True, False)], [[{"value": float("nan"), "type": "double"}],
                                 [{"value": -0.0, "type": "double"}],
                                 [{"value": 3, "type": "double"}]]),
    "date_and_decimal": ([(True, True), (False, True)],
                         [[{"value": 18001, "type": "date"},
                           {"value": 1234, "type": "decimal(9,2)"}],
                          [{"value": 18002, "type": "date"},
                           {"value": None, "type": "decimal(9,2)"}]]),
    "three_keys": ([(True, True), (False, False), (True, False)],
                   [[{"value": 1, "type": "long"}, {"value": 2.5, "type": "float"},
                     {"value": 9, "type": "timestamp"}]]),
}


@pytest.mark.parametrize("name", sorted(BOUND_CASES))
def test_range_partitioning_proto_equals_the_reference(name, monkeypatch):
    order, rows = BOUND_CASES[name]
    fields = _fields(order)
    n = len(rows) + 1
    want = jconverters._range_partitioning_proto(
        jconverters.convert_sort_fields(fields, JConf()), n, rows)
    monkeypatch.setitem(sys.modules, "pyarrow", None)  # the port's call must not need it
    got = pconverters._range_partitioning_proto(
        pconverters.convert_sort_fields(fields, PConf()), n, rows)
    assert list(got.range_bound_words) == list(want.range_bound_words)
    assert got.range_words_per_bound == want.range_words_per_bound == 2 * len(order)
    assert got.SerializeToString() == want.SerializeToString()


@pytest.mark.parametrize("rows,num", [
    ([[{"value": "m", "type": "string"}]], 2),                 # dictionary-encoded key
    ([], 4),                                                   # no sampled bounds
    ([[{"value": "12.50", "type": "decimal(9,2)"}]], 2),       # the serializer's decimal string
    ([[{"value": 1.5, "type": "decimal(9,2)"}]], 2),
])
def test_range_partitioning_proto_refuses_as_the_reference(rows, num):
    fields = _fields([(True, True)])
    with pytest.raises(Exception) as want:
        jconverters._range_partitioning_proto(
            jconverters.convert_sort_fields(fields, JConf()), num, rows)
    with pytest.raises(Exception) as got:
        pconverters._range_partitioning_proto(
            pconverters.convert_sort_fields(fields, PConf()), num, rows)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, (TypeError, ValueError))


def test_single_partition_without_bounds():
    fields = _fields([(True, True), (False, False)])
    want = jconverters._range_partitioning_proto(
        jconverters.convert_sort_fields(fields, JConf()), 1, [])
    got = pconverters._range_partitioning_proto(
        pconverters.convert_sort_fields(fields, PConf()), 1, [])
    assert got.SerializeToString() == want.SerializeToString()
