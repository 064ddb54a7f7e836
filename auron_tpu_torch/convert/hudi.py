"""Hudi COW table metadata -> table-format scan descriptor (port of
``auron_tpu/convert/hudi.py``).

Resolves a Copy-on-Write table directory (the ``.hoodie/`` commit timeline
and ``hoodie.properties``) into the neutral descriptor
``TableFormatScanProvider`` lowers to a pruned native parquet scan, against
the public Hudi table layout:

- completed instants only: ``.hoodie/<ts>.commit`` (and
  ``<ts>.replacecommit``) files, ordered by instant time; inflight and
  requested instants are invisible;
- the latest file slice per file group wins: every commit's
  ``partitionToWriteStats`` names (fileId, path); a later commit's write
  for the same fileId replaces the earlier file, and replacecommits drop
  the file groups they replace;
- the schema comes from the latest commit's ``extraMetadata.schema`` (an
  Avro record schema);
- partition columns come from ``hoodie.properties``
  (``hoodie.table.partitionfields``) matched against the hive-style
  partition path segments.
"""

from __future__ import annotations

import json
import os

#: avro primitive -> engine hostplan type name
_AVRO_TYPES = {
    "boolean": "boolean",
    "int": "int",
    "long": "long",
    "float": "float",
    "double": "double",
    "string": "string",
    "bytes": "binary",
}


def _engine_type(t) -> str:
    """Engine type name for an Avro schema node (unions unwrap null)."""
    if isinstance(t, list):  # union, e.g. ["null", "long"]
        non_null = [x for x in t if x != "null"]
        return _engine_type(non_null[0]) if non_null else "string"
    if isinstance(t, dict):
        lt = t.get("logicalType")
        if lt == "date":
            return "date"
        if lt in ("timestamp-millis", "timestamp-micros"):
            return "timestamp"
        if lt == "decimal":  # both Avro encodings: fixed- AND bytes-backed
            return f"decimal({t.get('precision', 38)},{t.get('scale', 18)})"
        return _engine_type(t.get("type", "string"))
    if t in _AVRO_TYPES:
        return _AVRO_TYPES[t]
    raise ValueError(f"unsupported hudi/avro type {t!r}")


def _read_properties(path: str) -> dict:
    props = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                props[k.strip()] = v.strip()
    except OSError:
        pass
    return props


def _partition_values(rel_path: str, partition_fields: list[str]) -> dict:
    """Partition values from a relative file path: hive-style ``k=v``
    segments by name, else positional against partition_fields."""
    segs = rel_path.split("/")[:-1]
    out = {}
    hive = {}
    for s in segs:
        if "=" in s:
            k, v = s.split("=", 1)
            hive[k] = v
    for i, f in enumerate(partition_fields):
        if f in hive:
            out[f] = hive[f]
        elif i < len(segs) and "=" not in segs[i]:
            out[f] = segs[i]
    return out


def resolve_hudi_scan(table_path: str) -> dict:
    """Resolve a real Hudi COW table directory into the HudiScanExec
    descriptor (hostplan node dict, filters empty — the converter merges
    the query's predicates)."""
    hoodie = os.path.join(table_path, ".hoodie")
    props = _read_properties(os.path.join(hoodie, "hoodie.properties"))
    table_type = props.get("hoodie.table.type", "COPY_ON_WRITE")
    if table_type != "COPY_ON_WRITE":
        raise ValueError(
            f"hudi table type {table_type!r} not supported (COW only; MOR "
            "log-file merging needs the format's own reader)"
        )
    part_fields = [
        p for p in props.get("hoodie.table.partitionfields", "").split(",") if p
    ]

    # completed commit timeline, instant-time order
    instants = []
    for fn in os.listdir(hoodie) if os.path.isdir(hoodie) else []:
        base = fn.split(".")
        if len(base) == 2 and base[1] in ("commit", "replacecommit"):
            instants.append((base[0], base[1], os.path.join(hoodie, fn)))
    instants.sort()

    # latest slice per file group (fileId); replaced groups drop
    slices: dict[str, tuple[str, str, int]] = {}  # fileId -> (ts, path, rows)
    schema_avro = None
    for ts, kind, path in instants:
        with open(path) as f:
            commit = json.load(f)
        meta_schema = (commit.get("extraMetadata") or {}).get("schema")
        if meta_schema:
            schema_avro = json.loads(meta_schema)
        for pstats in (commit.get("partitionToWriteStats") or {}).values():
            for st in pstats:
                fid = st.get("fileId")
                rel = st.get("path")
                if not fid or not rel:
                    continue
                slices[fid] = (ts, rel, int(st.get("numWrites", 0)))
        if kind == "replacecommit":
            for gids in (commit.get("partitionToReplaceFileIds") or {}).values():
                for fid in gids:
                    slices.pop(fid, None)

    if schema_avro is None:
        raise ValueError(f"no completed commit with a schema under {hoodie}")
    schema = [
        [f["name"], _engine_type(f["type"]),
         isinstance(f["type"], list) and "null" in f["type"]]
        for f in schema_avro["fields"]
        if not f["name"].startswith("_hoodie_")  # writer meta columns
    ]

    files = []
    for fid, (ts, rel, rows) in sorted(slices.items()):
        files.append({
            "path": os.path.join(table_path, rel),
            "partition": _partition_values(rel, part_fields),
            "record_count": rows,
            "format": "parquet",
        })
    return {
        "op": "HudiScanExec",
        "schema": schema,
        "args": {"files": files, "filters": [], "format": "parquet"},
    }
