"""Shuffle reader exec (port of ``auron_tpu/exec/shuffle/reader.py``, the
bucketed path ``reader.py:76-103``).

A block provider in the task resource map yields the raw v2 block payloads
of the task's reduce partition; each decodes to host column planes
(``format.decode_block``, column types from the plan schema) and the planes
of consecutive blocks assemble into ``bucket_capacity`` host buffers (a
dictionary column's blocks merged onto one vocabulary), sealed into one
batch (one host->device copy per column plane) once ``batch.size`` rows are
pending. Providers: ``LocalFileBlockProvider``
(one map output pair, with the pair-integrity check) and
``MultiMapBlockProvider`` (every map output of an exchange, or a
map-range slice of one partition for AQE skew splitting).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, DeviceBatch, bucket_capacity
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.shuffle.format import (
    DictCodes, decode_block, iter_block_payloads, read_data_tag, read_index_tagged,
)


class IpcReaderExec(ExecOperator):
    """Reads the shuffle blocks of the task's reduce partition."""

    def __init__(self, schema: T.Schema, resource_id: str):
        super().__init__([], schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        provider = ctx.resources[self.resource_id]
        target = ctx.batch_size()
        asm = _BucketAssembler(self.schema, resolve_device(ctx.device))
        for payload in provider.iter_payloads(partition):
            ctx.check_cancelled()
            ctx.metrics.add("shuffle_bytes_read", len(payload))
            with ctx.metrics.timer("decode_time"):
                asm.add(*decode_block(payload, self.schema))
            if asm.rows >= target:
                with ctx.metrics.timer("decode_time"):
                    b = asm.emit()
                yield b
        if asm.rows:
            with ctx.metrics.timer("decode_time"):
                b = asm.emit()
            yield b


class _BucketAssembler:
    """Decoded column chunks of consecutive blocks, sealed into one batch."""

    def __init__(self, schema: T.Schema, device: torch.device):
        self.schema = schema
        self.device = device
        self.rows = 0
        self.chunks: list[list] = [[] for _ in schema]

    def add(self, nrows: int, cols: list) -> None:
        if nrows == 0:
            return
        for i, col in enumerate(cols):
            self.chunks[i].append(col)
        self.rows += nrows

    def emit(self) -> Batch:
        rows, cap = self.rows, bucket_capacity(self.rows)
        values, validity, dicts = [], [], []
        for f, chunks in zip(self.schema, self.chunks):
            out = np.zeros(cap, dtype=f.dtype.numpy_dtype())
            out_m = np.zeros(cap, dtype=bool)
            vocab = None
            if f.dtype.is_dict_encoded:  # one vocabulary for the batch
                merged = DictCodes.concat([vals for vals, _ in chunks], f.dtype.is_nested)
                out[:rows], vocab = merged.codes, merged.vocab
            pos = 0
            for vals, valid in chunks:
                k = len(vals)
                if vocab is None:
                    out[pos:pos + k] = vals
                out_m[pos:pos + k] = True if valid is None else valid
                pos += k
            values.append(torch.from_numpy(out).to(self.device))
            validity.append(torch.from_numpy(out_m).to(self.device))
            dicts.append(vocab)
        sel = torch.arange(cap, device=self.device) < rows
        self.rows = 0
        self.chunks = [[] for _ in self.schema]
        return Batch(self.schema, DeviceBatch(sel, tuple(values), tuple(validity)), tuple(dicts))


class LocalFileBlockProvider:
    """Reads one (data, index) pair written by ShuffleWriterExec."""

    def __init__(self, data_file: str, index_file: str):
        self.data_file = data_file
        self.index_file = index_file

    def _region(self, partition: int) -> bytes:
        offsets, pair_tag = read_index_tagged(self.index_file)
        if pair_tag is not None:
            # concurrent attempts commit data and index with separate
            # renames: a mixed pair fails loudly so the task retries
            dtag = read_data_tag(self.data_file, offsets[-1])
            if dtag != pair_tag:
                raise RuntimeError(
                    f"shuffle pair mismatch: {self.data_file} tag={dtag} vs "
                    f"{self.index_file} tag={pair_tag} (concurrent attempt "
                    "commit interleaving); retry the task")
        start, stop = offsets[partition], offsets[partition + 1]
        if start == stop:
            return b""
        with open(self.data_file, "rb") as f:
            f.seek(start)
            return f.read(stop - start)

    def iter_payloads(self, partition: int) -> Iterator[bytes]:
        data = self._region(partition)
        if data:
            yield from iter_block_payloads(data)


class MultiMapBlockProvider:
    """Every map task's output pair of one exchange, for a reduce partition."""

    def __init__(self, pairs: list[tuple[str, str]]):
        self.pairs = pairs
        self.providers = [LocalFileBlockProvider(d, i) for d, i in pairs]

    def iter_payloads(self, partition: int) -> Iterator[bytes]:
        for p in self.providers:
            yield from p.iter_payloads(partition)

    def read_slice(self, partition: int, map_lo: int, map_hi: int) -> Iterator[bytes]:
        """One partition's blocks from the map outputs [map_lo, map_hi): the
        unit of an AQE skew split (a slice of the skewed side joins the full
        other side; ``reader.py:303-310``)."""
        for p in self.providers[map_lo:map_hi]:
            yield from p.iter_payloads(partition)
