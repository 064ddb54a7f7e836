"""Helpers for the port-vs-reference tests (tests/test_torch_*.py): build
the same batch content in both packages from numpy, carry an auron_tpu
batch's host planes into an auron_tpu_torch batch, and canonicalize rows
for comparison. Imports both packages; the port itself never does."""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from auron_tpu import types as JT
from auron_tpu.columnar.batch import Batch as JBatch

from auron_tpu_torch import types as PT
from auron_tpu_torch.columnar.batch import Batch as PBatch, DeviceBatch


class HostRef:
    """Host stand-in for a Pallas VMEM ref (``ref[:]`` read and write), to
    run a Pallas kernel body on host arrays."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, _):
        return self.v

    def __setitem__(self, _, v):
        self.v = v


def port_dtype(t: JT.DataType) -> PT.DataType:
    return PT.DataType(PT.TypeKind(t.kind.value), t.precision, t.scale,
                       tuple(port_dtype(i) for i in t.inner), tuple(t.struct_names))


def port_schema(s: JT.Schema) -> PT.Schema:
    return PT.Schema(tuple(PT.Field(f.name, port_dtype(f.dtype), f.nullable) for f in s))


def jax_batch(cols: dict, valid: dict | None = None) -> JBatch:
    """auron_tpu batch from numpy columns (object arrays -> strings)."""
    valid = valid or {}
    arrays = []
    for name, v in cols.items():
        m = valid.get(name)
        if v.dtype == object:
            vals = [x if (m is None or ok) else None for x, ok in
                    zip(v.tolist(), (m if m is not None else [True] * len(v)))]
            arrays.append(pa.array(vals, type=pa.string()))
        else:
            arrays.append(pa.array(v, mask=None if m is None else ~m))
    return JBatch.from_arrow(pa.RecordBatch.from_arrays(arrays, names=list(cols)))


def carry(jb: JBatch, device="cpu") -> PBatch:
    """The port batch holding exactly the reference batch's planes."""
    import jax

    dev = jax.device_get(jb.device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    dicts = []
    for d in jb.dicts:
        if d is None:
            dicts.append(None)
        else:
            arr = np.empty(len(d), dtype=object)
            for i, e in enumerate(d.to_pylist()):  # entry by entry: lists of equal length
                arr[i] = e
            dicts.append(arr)
    return PBatch(
        port_schema(jb.schema),
        DeviceBatch(t(dev.sel), tuple(t(v) for v in dev.values),
                    tuple(t(m) for m in dev.validity)),
        tuple(dicts),
    )


def rows(batches, decode=True) -> list[tuple]:
    """Live rows of a list of batches (either package) as tuples, NULL ->
    None, in emission order."""
    out = []
    for b in batches:
        cols = list(b.to_pydict().values())
        out.extend(zip(*cols))
    return out


def canon(rs: list[tuple]) -> list[tuple]:
    return sorted(rs, key=lambda r: tuple((x is None, x if x is not None else 0) for x in r))
