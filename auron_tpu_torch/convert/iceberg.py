"""Iceberg table metadata -> table-format scan descriptor (port of
``auron_tpu/convert/iceberg.py``).

Resolves a table directory (``metadata/v*.metadata.json``, the current
snapshot, the Avro manifest list and manifests, read by ``utils/avro.py``)
into the neutral descriptor ``TableFormatScanProvider`` lowers to a pruned
native parquet scan, against the public Iceberg spec v1/v2.
"""

from __future__ import annotations

import json
import os

from auron_tpu_torch.utils.avro import read_container

#: iceberg primitive -> engine hostplan type name
_TYPES = {
    "boolean": "boolean",
    "int": "int",
    "long": "long",
    "float": "float",
    "double": "double",
    "date": "date",
    "timestamp": "timestamp",
    "timestamptz": "timestamp",
    "string": "string",
    "binary": "binary",
}


def _engine_type(t) -> str:
    if isinstance(t, str):
        if t in _TYPES:
            return _TYPES[t]
        if t.startswith("decimal("):
            return t  # "decimal(p, s)" parses engine-side
    # nested (struct/list/map) and unknown types ship as an unparseable
    # tag: hostplan's schema parse marks the NODE degraded with a reason
    # instead of this resolver raising — one nested column must not block
    # resolution outright
    return f"iceberg:{json.dumps(t)}"


def _latest_metadata(table_path: str) -> str:
    meta_dir = os.path.join(table_path, "metadata")
    hint = os.path.join(meta_dir, "version-hint.text")
    if os.path.exists(hint):
        with open(hint) as f:
            v = f.read().strip()
        path = os.path.join(meta_dir, f"v{v}.metadata.json")
        if os.path.exists(path):
            return path
    def version_of(f: str) -> int:
        # "v3.metadata.json" (hadoop tables) or "00003-<uuid>.metadata.json"
        # (catalog tables): the leading integer is the version either way
        stem = f.split(".")[0].lstrip("v").split("-")[0]
        return int(stem) if stem.isdigit() else -1

    candidates = sorted(
        (f for f in os.listdir(meta_dir) if f.endswith(".metadata.json")),
        key=version_of,
    )
    if not candidates:
        raise FileNotFoundError(f"{meta_dir}: no metadata.json")
    return os.path.join(meta_dir, candidates[-1])


def _local_path(p: str, table_path: str) -> str:
    """Iceberg paths may be absolute URIs; strip file: schemes and remap
    the table location prefix (tables move; their metadata keeps the
    original absolute locations)."""
    if p.startswith("file://"):
        p = p[len("file://"):]
    if not os.path.isabs(p):
        return os.path.join(table_path, p)
    if not os.path.exists(p):
        # remap <orig-location>/... -> <table_path>/... by the marker dirs
        # (LAST occurrence: the original location may itself contain
        # /data/ or /metadata/ segments)
        for marker in ("/data/", "/metadata/"):
            i = p.rfind(marker)
            if i >= 0:
                cand = os.path.join(table_path, p[i + 1 :])
                if os.path.exists(cand):
                    return cand
    return p


def resolve_iceberg_scan(
    table_path: str, snapshot_id: int | None = None
) -> dict:
    """Resolve a real Iceberg table directory into the IcebergScanExec
    descriptor (hostplan node dict, filters empty — the converter merges
    the query's predicates)."""
    with open(_latest_metadata(table_path)) as f:
        meta = json.load(f)

    # schema: v2 "schemas"+"current-schema-id", v1 "schema"
    if "schemas" in meta:
        cur = meta.get("current-schema-id", 0)
        schema_json = next(s for s in meta["schemas"] if s.get("schema-id", 0) == cur)
    else:
        schema_json = meta["schema"]
    fields = schema_json["fields"]
    schema = [
        [f["name"], _engine_type(f["type"]), not f.get("required", False)]
        for f in fields
    ]
    field_names = {f["id"]: f["name"] for f in fields}

    # partition spec: source field ids -> names (identity transforms prune;
    # non-identity partition values are opaque to the pruner and pass)
    specs = {
        s.get("spec-id", 0): s["fields"]
        for s in meta.get("partition-specs", [{"spec-id": 0, "fields": meta.get("partition-spec", [])}])
    }

    snap_id = snapshot_id if snapshot_id is not None else meta.get("current-snapshot-id")
    snap = next(
        (s for s in meta.get("snapshots", []) if s["snapshot-id"] == snap_id), None
    )
    if snap is None:
        return {"op": "IcebergScanExec", "schema": schema,
                "args": {"files": [], "filters": [], "format": "parquet"}}

    files: list[dict] = []
    if "manifest-list" in snap:
        _, manifest_entries = read_container(
            _local_path(snap["manifest-list"], table_path)
        )
    else:
        # spec v1 alternative: inline manifest path array
        manifest_entries = [
            {"manifest_path": p, "partition_spec_id": 0}
            for p in snap.get("manifests", [])
        ]
    for m in manifest_entries:
        manifest_path = _local_path(m["manifest_path"], table_path)
        spec_fields = specs.get(m.get("partition_spec_id", 0), [])
        _, entries = read_container(manifest_path)
        for e in entries:
            if e.get("status") == 2:  # DELETED
                continue
            df = e["data_file"]
            if df.get("content", 0) != 0:  # only DATA files (no deletes)
                continue
            fmt = str(df.get("file_format", "PARQUET")).lower()
            if fmt != "parquet":
                # the provider lowers to a parquet scan; reading ORC/Avro
                # data files as parquet would crash or return garbage
                raise ValueError(
                    f"iceberg data file {df['file_path']}: format {fmt!r} "
                    "is not supported (parquet only)"
                )
            partition = {}
            pvals = df.get("partition") or {}
            for sf in spec_fields:
                if sf.get("transform", "identity") != "identity":
                    continue  # non-identity values can't prune literally
                col = field_names.get(sf["source-id"])
                if col is not None and sf["name"] in pvals:
                    partition[col] = pvals[sf["name"]]
            files.append({
                "path": _local_path(df["file_path"], table_path),
                "partition": partition,
                "record_count": int(df.get("record_count", 0)),
                "format": fmt,
            })
    return {
        "op": "IcebergScanExec",
        "schema": schema,
        "args": {"files": files, "filters": [], "format": "parquet"},
    }
