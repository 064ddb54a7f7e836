"""Paimon table metadata -> table-format scan descriptor (port of
``auron_tpu/convert/paimon.py``).

An append-only Paimon table directory (``schema/schema-N`` JSON,
``snapshot/snapshot-N`` JSON, Avro manifest lists and manifests, bucketed
data files) resolves into the neutral descriptor
``TableFormatScanProvider`` lowers to a pruned native parquet scan, against
the public Paimon file layout:

- the latest snapshot wins: the ``snapshot/LATEST`` hint (or the largest
  snapshot-N); its ``schemaId`` picks the TableSchema from
  ``schema/schema-<id>``;
- live files = ADD entries minus DELETE entries applied in order over the
  snapshot's BASE manifest list, then its DELTA manifest list;
- typed partition values decode from each entry's serialized BinaryRow
  ``_PARTITION`` key (a null value maps to the table's
  ``partition.default-name`` path segment);
- primary-key tables are refused: their LSM levels need merge-on-read
  (the format's own reader), as Hudi MOR is refused.
"""

from __future__ import annotations

import json
import os
import re

from auron_tpu_torch.utils.avro import read_container

#: Paimon SQL-style type string -> engine hostplan type name
_SIMPLE_TYPES = {
    "BOOLEAN": "boolean",
    "TINYINT": "int",
    "SMALLINT": "int",
    "INT": "int",
    "INTEGER": "int",
    "BIGINT": "long",
    "FLOAT": "float",
    "DOUBLE": "double",
    "STRING": "string",
    "BYTES": "binary",
    "BINARY": "binary",
    "VARBINARY": "binary",
    "DATE": "date",
}


def _engine_type(t: str) -> tuple[str, bool]:
    """(engine type name, nullable) for a Paimon type string like
    ``"BIGINT NOT NULL"`` / ``"DECIMAL(10, 2)"`` / ``"VARCHAR(32)"``."""
    s = t.strip()
    nullable = True
    up = s.upper()
    if up.endswith(" NOT NULL"):
        nullable = False
        up = up[: -len(" NOT NULL")].strip()
    base = up.split("(", 1)[0].strip()
    if base in _SIMPLE_TYPES:
        return _SIMPLE_TYPES[base], nullable
    if base in ("VARCHAR", "CHAR"):
        return "string", nullable
    if base == "DECIMAL":
        m = re.match(r"DECIMAL\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)", up)
        p, sc = (m.group(1), m.group(2)) if m else ("38", "18")
        return f"decimal({p},{sc})", nullable
    if base in ("TIMESTAMP", "TIMESTAMP_LTZ"):
        return "timestamp", nullable
    # nested (ARRAY/MAP/ROW) and unknown types ship as an unparseable tag:
    # hostplan's schema parse marks the NODE degraded with a reason instead
    # of this resolver raising — one nested column must not block
    # resolution outright (same contract as the Iceberg resolver)
    return f"paimon:{s}", nullable


def _decode_binary_row(data: bytes, types: list[str]) -> list:
    """Decode a Paimon BinaryRow (the Flink BinaryRowData layout): an
    8-bit header + null bitset, then one 8-byte little-endian slot per
    field; var-length values live past the fixed part, small strings
    inline in the slot with the high bit of the last byte set."""
    arity = len(types)
    null_bits = ((arity + 8 + 63) // 64) * 8
    out = []
    for i, t in enumerate(types):
        bit = 8 + i
        if data[bit >> 3] & (1 << (bit & 7)):
            out.append(None)
            continue
        slot = data[null_bits + 8 * i : null_bits + 8 * i + 8]
        base = t.split("(", 1)[0].split()[0].upper()
        if base in ("INT", "INTEGER", "DATE", "TINYINT", "SMALLINT"):
            out.append(int.from_bytes(slot[:4], "little", signed=True))
        elif base == "BIGINT":
            out.append(int.from_bytes(slot, "little", signed=True))
        elif base == "BOOLEAN":
            out.append(bool(slot[0]))
        elif base in ("STRING", "VARCHAR", "CHAR"):
            if slot[7] & 0x80:  # compact: <=7 bytes inline
                ln = slot[7] & 0x7F
                out.append(slot[:ln].decode("utf-8"))
            else:
                v = int.from_bytes(slot, "little", signed=False)
                off, size = v >> 32, v & 0xFFFFFFFF
                out.append(data[off : off + size].decode("utf-8"))
        else:
            raise ValueError(f"unsupported paimon partition type {t!r}")
    return out


def _latest_snapshot_id(snap_dir: str) -> int:
    hint = os.path.join(snap_dir, "LATEST")
    if os.path.exists(hint):
        with open(hint) as f:
            sid = int(f.read().strip())
        # hints are best-effort in the layout: a stale/corrupt hint must
        # fall back to listing, not crash on a missing snapshot file
        if os.path.exists(os.path.join(snap_dir, f"snapshot-{sid}")):
            return sid
    ids = [
        int(fn.split("-", 1)[1])
        for fn in os.listdir(snap_dir)
        if fn.startswith("snapshot-") and fn.split("-", 1)[1].isdigit()
    ]
    if not ids:
        raise ValueError(f"no snapshots under {snap_dir}")
    return max(ids)


def _partition_rel(partition: dict) -> str:
    """Hive-style relative dir for a partition-values dict (layout order
    is the table's partitionKeys order, which the caller preserves)."""
    return "/".join(f"{k}={v}" for k, v in partition.items())


def _manifest_entries(table_path: str, manifest_list: str) -> list[dict]:
    """Flatten a manifest list (Avro) into its manifests' entries, in
    list order (base before delta is the CALLER's contract)."""
    mdir = os.path.join(table_path, "manifest")
    entries: list[dict] = []
    _, lists = read_container(os.path.join(mdir, manifest_list))
    for rec in lists:
        name = rec.get("_FILE_NAME")
        if not name:
            continue
        _, recs = read_container(os.path.join(mdir, name))
        entries.extend(recs)
    return entries


def resolve_paimon_scan(table_path: str) -> dict:
    """Resolve a real append-only Paimon table directory into the
    PaimonScanExec descriptor (hostplan node dict, filters empty — the
    converter merges the query's predicates)."""
    snap_dir = os.path.join(table_path, "snapshot")
    sid = _latest_snapshot_id(snap_dir)
    with open(os.path.join(snap_dir, f"snapshot-{sid}")) as f:
        snapshot = json.load(f)

    with open(
        os.path.join(table_path, "schema", f"schema-{snapshot['schemaId']}")
    ) as f:
        table_schema = json.load(f)
    if table_schema.get("primaryKeys"):
        raise ValueError(
            "paimon primary-key table not supported (LSM merge-on-read "
            "needs the format's own reader); append-only tables resolve"
        )
    part_keys = table_schema.get("partitionKeys") or []
    schema = []
    for fld in table_schema["fields"]:
        t, nullable = _engine_type(fld["type"])
        schema.append([fld["name"], t, nullable])
    part_types = [
        next(f["type"] for f in table_schema["fields"] if f["name"] == k)
        for k in part_keys
    ]

    opts = table_schema.get("options") or {}
    file_format = opts.get("file.format", "orc")
    default_part = opts.get("partition.default-name", "__DEFAULT_PARTITION__")

    # live files: ADDs minus DELETEs, base list first, then delta
    live: dict[tuple, dict] = {}
    for part in ("baseManifestList", "deltaManifestList"):
        name = snapshot.get(part)
        if not name:
            continue
        for e in _manifest_entries(table_path, name):
            fmeta = e.get("_FILE") or {}
            fname = fmeta.get("_FILE_NAME")
            if not fname:
                continue
            bucket = int(e.get("_BUCKET", 0))
            praw = e.get("_PARTITION") or b""
            pvals = (
                _decode_binary_row(praw, part_types) if part_keys else []
            )
            partition = dict(zip(part_keys, pvals))
            # null partition values live under the default partition name
            path_parts = {
                k: (default_part if v is None else v)
                for k, v in partition.items()
            }
            key = (tuple(str(v) for v in partition.values()), bucket, fname)
            if int(e.get("_KIND", 0)) == 0:  # ADD
                rel = os.path.join(
                    _partition_rel(path_parts), f"bucket-{bucket}", fname
                ) if partition else os.path.join(f"bucket-{bucket}", fname)
                ffmt = ("parquet" if fname.endswith(".parquet")
                        else "orc" if fname.endswith(".orc")
                        else file_format)
                if ffmt != "parquet":
                    # the provider lowers to a parquet scan; reading
                    # ORC/Avro data files as parquet would crash or
                    # return garbage (same refusal as Iceberg)
                    raise ValueError(
                        f"paimon data file {fname}: format {ffmt!r} is "
                        "not supported (parquet only)"
                    )
                live[key] = {
                    "path": os.path.join(table_path, rel),
                    "partition": partition,
                    "record_count": int(fmeta.get("_ROW_COUNT", 0)),
                    "format": ffmt,
                }
            else:  # DELETE (compaction dropped this file)
                live.pop(key, None)

    files = [live[k] for k in sorted(live)]
    return {
        "op": "PaimonScanExec",
        "schema": schema,
        "args": {"files": files, "filters": [], "format": file_format},
    }
