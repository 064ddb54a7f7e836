"""Table-format scan conversion (port of ``auron_tpu/convert/table_formats.py``,
the reference's Iceberg/Hudi/Paimon plugins).

A table-format plugin resolves the format's metadata (snapshot ->
manifests -> data files with per-file partition values) into a native file
scan, pruning whole files with the query predicates before any I/O. The
host shim ships that metadata as a neutral descriptor:

    {"op": "IcebergScanExec",          # or HudiScanExec / PaimonScanExec
     "schema": [...],
     "args": {"files": [{"path": ..., "partition": {col: value, ...},
                         "record_count": N}, ...],
              "filters": [<expr>, ...],
              "format": "parquet"},
     "children": []}

and this provider lowers it to a ParquetScanNode over the files whose
partition values can satisfy the filters, with the predicates pushed into
the scan's row-group pruning, which the planner runs as ``ParquetScanExec``.
"""

from __future__ import annotations

import logging
import operator

from auron_tpu_torch.convert.exprs import convert_expr
from auron_tpu_torch.convert.hostplan import HostNode
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.utils.config import Configuration

_TABLE_SCAN_OPS = ("IcebergScanExec", "HudiScanExec", "PaimonScanExec")

_CMP = {
    "eq": operator.eq, "lt": operator.lt, "lteq": operator.le,
    "gt": operator.gt, "gteq": operator.ge, "neq": operator.ne,
}


def _file_may_match(e: ir.Expr, schema, partition: dict) -> bool:
    """Can any row of a file with these partition values satisfy e?
    Conservative: unknown shapes and non-partition columns give True."""
    if isinstance(e, ir.BinaryOp):
        if e.op == "and":
            return (_file_may_match(e.left, schema, partition)
                    and _file_may_match(e.right, schema, partition))
        if e.op == "or":
            return (_file_may_match(e.left, schema, partition)
                    or _file_may_match(e.right, schema, partition))
        if e.op in _CMP and isinstance(e.left, ir.Column) and isinstance(e.right, ir.Literal):
            name = schema[e.left.index].name
            if name not in partition:
                return True  # not a partition column: cannot prune
            v = partition[name]
            lit_v = e.right.value
            if v is None or lit_v is None:
                return False  # NULL never satisfies a comparison
            if not _comparable(v, lit_v):
                return True  # cross-type metadata (e.g. '2023' vs 2023)
            try:
                return bool(_CMP[e.op](v, lit_v))
            except TypeError:
                return True
    if isinstance(e, ir.In) and isinstance(e.child, ir.Column) and not e.negated:
        name = schema[e.child.index].name
        if name not in partition:
            return True
        v = partition[name]
        if not all(_comparable(v, i) for i in e.items if i is not None):
            return True
        return v in set(e.items)
    return True


def _comparable(a, b) -> bool:
    """Same-type (or numeric/numeric) values can be pruned on; anything else
    (string partition metadata against an int literal) stays conservative,
    or matching files would vanish."""
    num = (int, float)
    if isinstance(a, num) and isinstance(b, num):
        return True
    return type(a) is type(b)


class TableFormatScanProvider:
    """One provider covers all three formats: the descriptor is the
    format-neutral output of their metadata resolution."""

    def is_supported(self, node: HostNode) -> bool:
        return node.op in _TABLE_SCAN_OPS and "files" in node.args

    def is_enabled(self, node: HostNode, conf: Configuration) -> bool:
        from auron_tpu_torch.convert.providers import TABLE_FORMATS_ENABLE

        return conf.get(TABLE_FORMATS_ENABLE)

    def convert(self, node: HostNode, children, conf: Configuration):
        assert not children
        filters = [convert_expr(f, conf) for f in node.args.get("filters", [])]
        kept: list[str] = []
        pruned = 0
        for f in node.args["files"]:
            part = f.get("partition") or {}
            if all(_file_may_match(e, node.schema, part) for e in filters):
                kept.append(f["path"])
            else:
                pruned += 1
        fmt = node.args.get("format", "parquet")
        if fmt != "parquet":
            raise ValueError(f"table-format data files must be parquet, got {fmt}")
        scan = B.parquet_scan(node.schema, kept, filters, node.args.get("fs_resource_id", ""))
        if pruned:
            logging.getLogger("auron_tpu_torch").info(
                "%s: pruned %d/%d data files by partition values", node.op, pruned,
                pruned + len(kept))
        return scan
