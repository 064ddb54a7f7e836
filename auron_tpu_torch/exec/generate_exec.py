"""Generate (table-generating functions) exec.

Port of ``auron_tpu/exec/generate_exec.py`` (the reference's
generate_exec.rs + generate/{explode,json_tuple}.rs): ``explode`` and
``pos_explode`` (with ``outer``), ``json_tuple`` and ``host_udtf``, a table
function registered with the bridge (``bridge/udf.py``): one batched read
brings the generator argument to the host, the callback expands each live
row, and the required columns repeat per generated row by a gather on the
device (reference ``generate_exec.py:149-187``).

A LIST column is dictionary-encoded: int32 codes on the device, one Python
list per vocabulary entry on the host. The vocabulary gives the flattened
element column and the per-entry length and offset tables once per input
batch; the per-row expansion is then a ragged cumsum and ``searchsorted``
on the device, all gathers, with ONE blocking host read per input batch:
the exploded row total, which sizes the output (counted in the operator's
``blocking_reads``). The output leaves in chunks of ``_CHUNK`` rows, each
at ``bucket_capacity`` of its rows, so the batches line up one for one
with the reference's. Per input batch the operator counts
``generate_batches``, ``generate_chunks`` and ``exploded_rows``.
"""

from __future__ import annotations

import json
from typing import Iterator

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, bucket_capacity, column_from_pylist, \
    object_array
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.runtime.transfer import blocking_read

_CHUNK = 1 << 16
GENERATORS = ("explode", "pos_explode", "json_tuple", "host_udtf")


class GenerateExec(ExecOperator):
    def __init__(
        self,
        child: ExecOperator,
        generator: str,  # "explode" | "pos_explode" | "json_tuple" | "host_udtf"
        gen_expr: ir.Expr,
        required_cols: list[int],
        outer: bool = False,
        json_fields: list[str] | None = None,
        elem_name: str = "col",
        pos_name: str = "pos",
        udtf: str | None = None,  # a bridge-registered table function (host_udtf)
    ):
        if generator not in GENERATORS:
            raise ValueError(f"unknown generator {generator}")
        self.generator = generator
        self.gen_expr = gen_expr
        self.required_cols = required_cols
        self.outer = outer
        self.json_fields = json_fields or []
        fields = [child.schema[i] for i in required_cols]
        gen_dtype = gen_expr.dtype_of(child.schema)
        self.udtf = udtf
        if generator == "json_tuple":
            fields += [T.Field(f, T.STRING, True) for f in self.json_fields]
        elif generator == "host_udtf":
            from auron_tpu_torch.bridge.udf import lookup_udtf

            fields += list(lookup_udtf(udtf)[1].fields)
        else:
            if gen_dtype.kind != T.TypeKind.LIST:
                raise TypeError(f"{generator} requires a LIST input, not {gen_dtype}")
            if generator == "pos_explode":
                fields.append(T.Field(pos_name, T.INT32, False))
            fields.append(T.Field(elem_name, gen_dtype.inner[0], True))
        super().__init__([child], T.Schema(tuple(fields)))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        ev = Evaluator(self.children[0].schema, partition_id=ctx.partition_id,
                       resources=ctx.resources)
        for b in self.child_stream(0, partition, ctx):
            ctx.check_cancelled()
            ctx.metrics.add("generate_batches", 1)
            with ctx.metrics.timer("elapsed_compute"):
                cv = ev.evaluate(b, [self.gen_expr])[0]
            if self.generator == "json_tuple":
                with ctx.metrics.timer("elapsed_compute"):
                    out = self._json_tuple(b, cv)
                ctx.metrics.add("generate_chunks", 1)
                yield out
            elif self.generator == "host_udtf":
                yield from self._host_udtf(b, cv, ctx)
            else:
                yield from self._explode(b, cv, ctx)

    # ------------------------------------------------------------------

    def _required(self, b: Batch, idx: torch.Tensor | None, ok: torch.Tensor):
        cols, names = [], []
        for out_i, ci in enumerate(self.required_cols):
            v, m = b.col_values(ci), b.col_validity(ci)
            if idx is not None:
                v, m = v[idx], m[idx]
            cols.append(ColumnVal(v, m & ok, self.children[0].schema[ci].dtype, b.dicts[ci]))
            names.append(self.schema[out_i].name)
        return cols, names

    def _explode(self, b: Batch, cv: ColumnVal, ctx) -> Iterator[Batch]:
        dev = b.torch_device
        entries = cv.dict
        elem_dtype = self.schema[-1].dtype
        with ctx.metrics.timer("elapsed_compute"):
            lens_np = np.array([len(e) if e is not None else 0 for e in entries], dtype=np.int64)
            offs_np = np.zeros(len(entries) + 1, dtype=np.int64)
            np.cumsum(lens_np, out=offs_np[1:])
            flat = [x for e in entries if e is not None for x in e]
            flat_cap = bucket_capacity(max(len(flat), 1))
            ev_vals, ev_mask, ev_dict = column_from_pylist(flat, elem_dtype, flat_cap, dev)
            # the per-entry tables go to the device once per input batch
            lens_t = torch.from_numpy(lens_np).to(dev)
            offs_t = torch.from_numpy(offs_np[:-1].copy()).to(dev)
            codes = cv.values.long().clamp(0, max(len(entries) - 1, 0))
            row_len = lens_t[codes]
            row_off = offs_t[codes]
            live = b.device.sel
            has_elems = cv.validity & (row_len > 0)
            if self.outer:
                # a live row that is NULL or holds an empty list gives one row
                counts = torch.where(live, torch.where(has_elems, row_len, 1), 0)
            else:
                counts = torch.where(live & has_elems, row_len, 0)
            offsets = torch.cumsum(counts, 0)
        (total_np,) = blocking_read(ctx.metrics, offsets[-1:])
        total = int(total_np[0])
        if total == 0:
            return
        ctx.metrics.add("exploded_rows", total)
        starts = offsets - counts
        cap_in = b.capacity
        for cstart in range(0, total, _CHUNK):
            with ctx.metrics.timer("elapsed_compute"):
                ccap = bucket_capacity(min(_CHUNK, total - cstart))
                t = torch.arange(cstart, cstart + ccap, dtype=torch.int64, device=dev)
                ok = t < total
                li = torch.searchsorted(offsets, t, right=True).clamp_(0, cap_in - 1)
                within = t - starts[li]
                real_elem = has_elems[li] & ok
                eidx = (row_off[li] + within).clamp_(0, flat_cap - 1)

                cols, names = self._required(b, li, ok)
                if self.generator == "pos_explode":
                    cols.append(ColumnVal(within.to(torch.int32), real_elem, T.INT32))
                    names.append(self.schema[len(self.required_cols)].name)
                cols.append(ColumnVal(ev_vals[eidx], ev_mask[eidx] & real_elem, elem_dtype,
                                      ev_dict))
                names.append(self.schema[-1].name)
                out = batch_from_columns(cols, names, ok)
            ctx.metrics.add("generate_chunks", 1)
            yield Batch(self.schema, out.device, out.dicts)

    def _host_udtf(self, b: Batch, cv: ColumnVal, ctx) -> Iterator[Batch]:
        """A bridge-registered table function over the live rows: their
        generator values in one batched read, the callback per row (an
        ``outer`` row that generates nothing gives one row of NULLs), the
        generated columns up to the device and the required columns
        gathered by input row, in chunks of ``_CHUNK`` rows."""
        from auron_tpu_torch.bridge.udf import lookup_udtf
        from auron_tpu_torch.columnar.batch import host_pylists

        fn, out_schema = lookup_udtf(self.udtf)
        dev = b.torch_device
        sel = ColumnVal(b.device.sel, torch.ones_like(b.device.sel), T.BOOL)
        with ctx.metrics.timer("elapsed_compute"):
            vals, live = host_pylists([cv, sel], ctx.metrics)
            src, gen = [], []
            width = len(out_schema)
            for i, v in enumerate(vals):
                if not live[i]:
                    continue
                rows = fn(v) if v is not None else []
                if not rows and self.outer:
                    rows = [(None,) * width]
                src += [i] * len(rows)
                gen += rows
        total = len(src)
        if total == 0:
            return
        ctx.metrics.add("exploded_rows", total)
        for cstart in range(0, total, _CHUNK):
            with ctx.metrics.timer("elapsed_compute"):
                k = min(_CHUNK, total - cstart)
                ccap = bucket_capacity(k)
                li = torch.zeros(ccap, dtype=torch.int64)
                li[:k] = torch.as_tensor(src[cstart:cstart + k], dtype=torch.int64)
                ok = torch.arange(ccap, device=dev) < k
                cols, names = self._required(b, li.to(dev), ok)
                chunk = gen[cstart:cstart + k]
                for gi, f in enumerate(out_schema):
                    v, m, d = column_from_pylist([r[gi] for r in chunk], f.dtype, ccap, dev)
                    cols.append(ColumnVal(v, m & ok, f.dtype, d))
                    names.append(f.name)
                out = batch_from_columns(cols, names, ok)
            ctx.metrics.add("generate_chunks", 1)
            yield Batch(self.schema, out.device, out.dicts)

    def _json_tuple(self, b: Batch, cv: ColumnVal) -> Batch:
        entries = cv.dict
        per_field: list[list] = [[] for _ in self.json_fields]
        for s in entries:
            try:
                obj = json.loads(s) if s is not None else None
            except (ValueError, TypeError):
                obj = None
            for fi, f in enumerate(self.json_fields):
                v = None
                if isinstance(obj, dict) and f in obj and obj[f] is not None:
                    v = obj[f] if isinstance(obj[f], str) else json.dumps(obj[f])
                per_field[fi].append(v)

        cols, names = self._required(b, None, torch.ones_like(b.device.sel))
        dev = b.torch_device
        codes = cv.values.long().clamp(0, max(len(entries) - 1, 0))
        for fi, fname in enumerate(self.json_fields):
            fv = per_field[fi]
            ok_np = np.array([v is not None for v in fv], dtype=bool)
            vocab: dict = {}
            remap = np.empty(len(fv), dtype=np.int32)
            for i, v in enumerate(fv):
                remap[i] = vocab.setdefault(v if v is not None else "", len(vocab))
            cols.append(ColumnVal(torch.from_numpy(remap).to(dev)[codes],
                                  cv.validity & torch.from_numpy(ok_np).to(dev)[codes],
                                  T.STRING, object_array(list(vocab) or [""])))
            names.append(fname)
        out = batch_from_columns(cols, names, b.device.sel)
        return Batch(self.schema, out.device, out.dicts)
