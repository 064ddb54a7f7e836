"""Helpers for the port-vs-reference join tests (tests/test_torch_joins_tail.py,
test_torch_join_chain.py, test_torch_predicted_compaction.py): the same
numpy columns as batches of both packages, and a join tree run through
both with one conf. Imports both packages; the port itself never does."""

from __future__ import annotations

import numpy as np

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.joins import BroadcastHashJoinExec as JBHJ, SortMergeJoinExec as JSMJ
from auron_tpu.exprs import ir as jir
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec as PSMJ
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, rows

#: (ir module, scan, hash join, sort-merge join) of each package
JAX = (jir, JScan, JBHJ, JSMJ)
PORT = (pir, PScan, PBHJ, PSMJ)


def batches(cols: dict, valid: dict | None = None, chunk: int | None = None) -> list:
    """auron_tpu batches of ``chunk`` rows (one batch when None; one empty
    batch for no rows)."""
    valid = valid or {}
    n = len(next(iter(cols.values())))
    step = chunk or max(n, 1)
    return [jax_batch({k: v[i:i + step] for k, v in cols.items()},
                      {k: m[i:i + step] for k, m in valid.items()})
            for i in range(0, max(n, 1), step)]


def scan(pkg, parts: list) -> object:
    """A one-partition scan of auron_tpu batches in ``pkg`` (JAX or PORT)."""
    if pkg is PORT:
        parts = [carry(b) for b in parts]
    return pkg[1]([parts], parts[0].schema)


def run(pkg, op, conf: dict | None = None, metrics: bool = False):
    """Rows of partition 0 of ``op``, canonicalized (and, for the port,
    the metric tree's snapshot)."""
    if pkg is PORT:
        ctx = PCtx(conf=PConf(dict(conf or {})), device="cpu")
    else:
        ctx = JCtx(conf=JConf(dict(conf or {})))
    out = canon(rows(list(op.execute(0, ctx))))
    return (out, ctx.metrics.snapshot()) if metrics else out


def counter(snapshot: dict, name: str) -> int:
    """``name`` summed over a metric-tree snapshot."""
    return snapshot["values"].get(name, 0) + sum(counter(c, name)
                                                  for c in snapshot["children"])


def join(pkg, kind: str, left: list, right: list, jt: str, lkeys=(0,), rkeys=(0,),
         condition=None, **kw):
    """``kind`` in smj | bhj_right | bhj_left over one-partition scans."""
    ir, _, bhj, smj = pkg
    lk, rk = [ir.col(i) for i in lkeys], [ir.col(i) for i in rkeys]
    cond = condition(ir) if condition else None
    if kind == "smj":
        return smj(scan(pkg, left), scan(pkg, right), lk, rk, jt, condition=cond, **kw)
    return bhj(scan(pkg, left), scan(pkg, right), lk, rk, jt,
               build_side="left" if kind == "bhj_left" else "right", condition=cond, **kw)


def both(kind, left, right, jt, lkeys=(0,), rkeys=(0,), condition=None, conf=None, **kw):
    """(port rows, reference rows), each canonicalized."""
    want = run(JAX, join(JAX, kind, left, right, jt, lkeys, rkeys, condition, **kw), conf)
    got = run(PORT, join(PORT, kind, left, right, jt, lkeys, rkeys, condition, **kw), conf)
    return got, want


def star(pkg, fact: list, dims: list, fact_keys: list, **kw):
    """fact JOIN dim0 ON fact[k0] = dim0[0] JOIN dim1 ON fact[k1] = dim1[0] ...
    (inner, builds on the right), the stack the fused chain takes."""
    ir, _, bhj, _ = pkg
    node = scan(pkg, fact)
    for dim, fk in zip(dims, fact_keys):
        node = bhj(node, scan(pkg, dim), [ir.col(fk)], [ir.col(0)], "inner",
                   build_side="right", **kw)
    return node


def int_cols(**cols) -> dict:
    return {k: np.asarray(v) for k, v in cols.items()}
