"""Shared inputs of the host-boundary tests (tests/test_torch_arrow_c.py,
test_torch_arrow_ipc.py, test_torch_bridge.py): one pyarrow array per
Arrow format of the port's list, made from a seeded numpy generator, a
reference ingest that decodes each column with pyarrow and builds the port
batch with ``Batch.from_numpy`` (independent of the C import and of
``from_host_arrow``), a reference egress that builds each column with
pyarrow from ``Batch.to_numpy`` (independent of the C export and of
``to_host_arrow``), and an exact comparison of two port batches."""

import ctypes
import decimal

import numpy as np
import pyarrow as pa
import torch

from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, empty_dict, encode_values

N = 300


def columns(n: int = N, seed: int = 3) -> dict:
    """One pyarrow array per format of the port's list (NULLs in most)."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.25

    def ints(lo, hi, dt):
        return pa.array(rng.integers(lo, hi, n).astype(dt), mask=null)

    def pylist(f):
        return [None if m else f(i) for i, m in enumerate(null)]

    dec = rng.integers(-10**15, 10**15, n)
    return {
        "c": ints(-128, 127, np.int8), "s": ints(-2**15, 2**15, np.int16),
        "i": ints(-2**31, 2**31, np.int32), "l": ints(-2**62, 2**62, np.int64),
        "C": ints(0, 255, np.uint8), "S": ints(0, 2**16, np.uint16),
        "I": ints(0, 2**32, np.uint32), "L": pa.array(rng.integers(0, 2**62, n).astype(np.uint64)),
        "f": pa.array(rng.normal(size=n).astype(np.float32), mask=null),
        "g": pa.array(rng.normal(size=n), mask=null),
        "b": pa.array(rng.random(n) < 0.5, mask=null),
        "tdD": ints(-10**5, 10**5, np.int32).cast(pa.date32()),
        "tsu": ints(-10**15, 10**15, np.int64).cast(pa.timestamp("us")),
        "tsu_tz": ints(0, 10**15, np.int64).cast(pa.timestamp("us", tz="UTC")),
        "tsm": ints(-10**11, 10**11, np.int64).cast(pa.timestamp("ms")),
        "tss": ints(-10**8, 10**8, np.int64).cast(pa.timestamp("s")),
        "d64": pa.array(pylist(lambda i: decimal.Decimal(int(dec[i])).scaleb(-2)),
                        pa.decimal128(18, 2)),
        "d128": pa.array(pylist(lambda i: decimal.Decimal(int(dec[i]) * 10**18).scaleb(-6)),
                         pa.decimal128(38, 6)),
        "u": pa.array(pylist(lambda i: f"v{int(dec[i]) % 17}é")),
        "U": pa.array(pylist(lambda i: f"w{int(dec[i]) % 5}"), pa.large_string()),
        "z": pa.array(pylist(lambda i: bytes([int(dec[i]) % 7, 0])), pa.binary()),
        "Z": pa.array(pylist(lambda i: bytes([int(dec[i]) % 3])), pa.large_binary()),
        "dict_u": pa.array(pylist(lambda i: f"k{int(dec[i]) % 4}")).dictionary_encode(),
        "dict_i8": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 3, n).astype(np.int8), mask=null),
            pa.array(["x", "yy", "zzz"])),
        "+l": pa.array(pylist(lambda i: [int(x) for x in range(int(dec[i]) % 4)]),
                       pa.list_(pa.int64())),
        "+L": pa.array(pylist(lambda i: [f"e{x}" for x in range(int(dec[i]) % 3)]),
                       pa.large_list(pa.string())),
    }


COLUMNS = list(columns(8))
SLICES = [(0, N), (37, 123), (N // 2, 0)]


def record_batch(name: str, sl) -> pa.RecordBatch:
    return pa.RecordBatch.from_arrays([columns()[name]], [name]).slice(*sl)


def pyarrow_ingest(rb: pa.RecordBatch, device="cpu") -> Batch:
    """The port batch of ``rb`` with every column decoded by pyarrow and
    encoded by ``Batch.from_numpy``'s own encoders."""
    import pyarrow.compute as pc

    schema = T.Schema.from_arrow(rb.schema)
    cols, masks, dicts = [], [], []
    for i, f in enumerate(schema):
        arr = rb.column(i)
        valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
        if f.dtype.kind == T.TypeKind.LIST:
            cols.append(arr.to_pylist())
            dicts.append(None)
        elif f.dtype.is_wide_decimal and not pa.types.is_dictionary(arr.type):
            vals = np.empty(len(arr), dtype=object)
            vals[:] = arr.cast(f.dtype.to_arrow()).to_pylist()
            cols.append(vals)
            dicts.append(None)
        elif f.dtype.is_dict_encoded:
            if pa.types.is_dictionary(arr.type):
                codes = arr.indices.fill_null(0).to_numpy(zero_copy_only=False)
                vocab = np.empty(len(arr.dictionary), dtype=object)
                vocab[:] = arr.dictionary.to_pylist()
                cols.append(codes.astype(np.int32))
                dicts.append(vocab if len(vocab) else empty_dict(f.dtype))
            else:
                vals = np.empty(len(arr), dtype=object)
                vals[:] = arr.to_pylist()
                codes, vocab = encode_values(vals, valid)
                cols.append(codes)
                dicts.append(vocab)
        elif f.dtype.kind == T.TypeKind.DECIMAL:
            vals = np.empty(len(arr), dtype=object)
            vals[:] = arr.cast(pa.decimal128(38, f.dtype.scale)).to_pylist()
            cols.append(vals)
            dicts.append(None)
        else:
            if f.dtype.kind == T.TypeKind.TIMESTAMP:
                arr = arr.cast(pa.timestamp("us")).cast(pa.int64())
            elif f.dtype.kind == T.TypeKind.DATE32:
                arr = arr.cast(pa.int32())
            else:
                arr = arr.cast(f.dtype.to_arrow())
            if arr.null_count:
                arr = arr.fill_null(False if f.dtype.kind == T.TypeKind.BOOL else 0)
            cols.append(arr.to_numpy(zero_copy_only=False))
            dicts.append(None)
        masks.append(valid)
    return Batch.from_numpy(cols, schema, masks, dicts, None, device)


def pyarrow_egress(b: Batch) -> pa.RecordBatch:
    """The live rows of ``b`` as a RecordBatch with every column built by
    pyarrow from ``Batch.to_numpy``."""
    arrays = []
    for f, (v, m) in zip(b.schema, b.to_numpy().values()):
        if f.dtype.is_dict_encoded:
            arrays.append(pa.array(list(v), type=f.dtype.to_arrow()))
        elif f.dtype.kind == T.TypeKind.DECIMAL:
            arrays.append(pa.array([T.decimal_from_unscaled(x, f.dtype.scale) if ok
                                    else None for x, ok in zip(v.tolist(), m.tolist())],
                                   type=f.dtype.to_arrow()))
        else:
            arrays.append(pa.array(v, mask=~m).cast(f.dtype.to_arrow()))
    return pa.RecordBatch.from_arrays(arrays, schema=b.schema.to_arrow())


def assert_batches_equal(got: Batch, want: Batch) -> None:
    assert got.schema == want.schema
    assert got.capacity == want.capacity
    assert torch.equal(got.device.sel, want.device.sel)
    for i, f in enumerate(want.schema):
        assert torch.equal(got.device.validity[i], want.device.validity[i]), f.name
        assert torch.equal(got.device.values[i], want.device.values[i]), f.name
        gd, wd = got.dicts[i], want.dicts[i]
        assert (gd is None) == (wd is None), f.name
        if wd is not None:
            assert list(gd) == list(wd), f.name


def export(rb: pa.RecordBatch) -> C.HostBatch:
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    rb._export_to_c(ctypes.addressof(arr), ctypes.addressof(sch))
    return C.import_batch(ctypes.addressof(arr), ctypes.addressof(sch))
