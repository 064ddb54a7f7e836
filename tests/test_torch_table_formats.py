"""Table formats: the port's ``convert/hudi.py``, ``iceberg.py``,
``paimon.py``, ``table_formats.py`` and ``utils/avro.py`` against the
reference's, on the fixtures tests/test_hudi.py, test_iceberg.py and
test_paimon.py build (real table directories, Parquet written with
pyarrow).

- ``resolve_hudi_scan``, ``resolve_iceberg_scan`` and ``resolve_paimon_scan``
  give the reference's descriptors, and refuse what it refuses with its
  message;
- Avro containers written by either package read back in the other (null
  and deflate codecs), and the binary encodings are byte-equal;
- the provider's file pruning (``_file_may_match``) and the scan it lowers
  to equal the reference's.
"""

import json
import os

import pytest

import test_hudi
import test_iceberg
import test_paimon
from auron_tpu.convert import hudi as jhudi
from auron_tpu.convert import iceberg as jiceberg
from auron_tpu.convert import paimon as jpaimon
from auron_tpu.convert import table_formats as jtf
from auron_tpu.convert.converters import convert_plan as jconvert
from auron_tpu.convert.exprs import convert_expr as jconvert_expr
from auron_tpu.convert.hostplan import parse_type as jparse_type
from auron_tpu.utils import avro as javro
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.convert import hudi as phudi
from auron_tpu_torch.convert import iceberg as piceberg
from auron_tpu_torch.convert import paimon as ppaimon
from auron_tpu_torch.convert import table_formats as ptf
from auron_tpu_torch.convert.converters import convert_plan as pconvert
from auron_tpu_torch.convert.exprs import convert_expr as pconvert_expr
from auron_tpu_torch.convert.hostplan import parse_type
from auron_tpu_torch.utils import avro as pavro
from auron_tpu_torch.utils.config import Configuration as PConf


def _same_raise(jfn, pfn, *args):
    with pytest.raises(Exception) as want:
        jfn(*args)
    with pytest.raises(Exception) as got:
        pfn(*args)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_hudi_resolution_equals_the_reference(tmp_path):
    test_hudi._build_table(str(tmp_path))
    want = jhudi.resolve_hudi_scan(str(tmp_path))
    assert phudi.resolve_hudi_scan(str(tmp_path)) == want
    assert len(want["args"]["files"]) >= 2


def test_hudi_refusals_equal_the_reference(tmp_path):
    mor = tmp_path / "mor"
    (mor / ".hoodie").mkdir(parents=True)
    (mor / ".hoodie" / "hoodie.properties").write_text("hoodie.table.type=MERGE_ON_READ\n")
    _same_raise(jhudi.resolve_hudi_scan, phudi.resolve_hudi_scan, str(mor))
    empty = tmp_path / "empty"
    (empty / ".hoodie").mkdir(parents=True)
    _same_raise(jhudi.resolve_hudi_scan, phudi.resolve_hudi_scan, str(empty))


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_iceberg_resolution_equals_the_reference(tmp_path, codec):
    test_iceberg._build_table(str(tmp_path), codec=codec)
    want = jiceberg.resolve_iceberg_scan(str(tmp_path))
    assert piceberg.resolve_iceberg_scan(str(tmp_path)) == want
    assert len(want["args"]["files"]) == 2
    for sid in (77, 12345):
        assert piceberg.resolve_iceberg_scan(str(tmp_path), snapshot_id=sid) == \
            jiceberg.resolve_iceberg_scan(str(tmp_path), snapshot_id=sid)


def test_iceberg_nested_column_and_orc_file(tmp_path):
    test_iceberg._build_table(str(tmp_path))
    meta_path = os.path.join(str(tmp_path), "metadata", "v3.metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["schemas"][0]["fields"].append({"id": 9, "name": "nested", "required": False,
                                         "type": {"type": "struct", "fields": []}})
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert piceberg.resolve_iceberg_scan(str(tmp_path)) == \
        jiceberg.resolve_iceberg_scan(str(tmp_path))
    meta_dir = os.path.join(str(tmp_path), "metadata")
    pavro.write_container(os.path.join(meta_dir, "m1.avro"), test_iceberg.MANIFEST_SCHEMA, [
        {"status": 1, "data_file": {"content": 0, "file_path": "/x/f.orc",
                                    "file_format": "ORC", "partition": {"year": 2023},
                                    "record_count": 1}}])
    _same_raise(jiceberg.resolve_iceberg_scan, piceberg.resolve_iceberg_scan, str(tmp_path))


def test_paimon_resolution_equals_the_reference(tmp_path):
    test_paimon._build_table(str(tmp_path))
    want = jpaimon.resolve_paimon_scan(str(tmp_path))
    assert ppaimon.resolve_paimon_scan(str(tmp_path)) == want
    assert len(want["args"]["files"]) == 2
    row = test_paimon._binary_row_bigint(2024)
    assert ppaimon._decode_binary_row(row, ["BIGINT"]) == \
        jpaimon._decode_binary_row(row, ["BIGINT"])


def test_paimon_refusals_equal_the_reference(tmp_path):
    test_paimon._build_table(str(tmp_path))
    path = os.path.join(str(tmp_path), "schema", "schema-0")
    with open(path) as f:
        schema = json.load(f)
    schema["primaryKeys"] = ["id"]
    with open(path, "w") as f:
        json.dump(schema, f)
    _same_raise(jpaimon.resolve_paimon_scan, ppaimon.resolve_paimon_scan, str(tmp_path))
    os.makedirs(tmp_path / "bare" / "snapshot")
    _same_raise(jpaimon.resolve_paimon_scan, ppaimon.resolve_paimon_scan,
                str(tmp_path / "bare"))


AVRO_SCHEMA = {
    "type": "record", "name": "r", "fields": [
        {"name": "b", "type": "boolean"},
        {"name": "i", "type": "int"},
        {"name": "l", "type": ["null", "long"]},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "s", "type": "string"},
        {"name": "y", "type": "bytes"},
        {"name": "x", "type": {"type": "fixed", "name": "x4", "size": 4}},
        {"name": "e", "type": {"type": "enum", "name": "e", "symbols": ["A", "B", "C"]}},
        {"name": "a", "type": {"type": "array", "items": "long"}},
        {"name": "m", "type": {"type": "map", "values": ["null", "string"]}},
        {"name": "n", "type": {"type": "record", "name": "n", "fields": [
            {"name": "ts", "type": {"type": "long", "logicalType": "timestamp-micros"}}]}},
    ]}


def _records(n: int = 40) -> list:
    return [{"b": i % 2 == 0, "i": -i * 1000, "l": None if i % 3 == 0 else (1 << 40) - i,
             "f": 0.5 * i, "d": -1.25 * i, "s": f"str-{i}-é", "y": bytes([i, 255 - i]),
             "x": bytes([i, i, 0, 1]), "e": "ABC"[i % 3], "a": list(range(-1, i % 5)),
             "m": {f"k{j}": (None if j == 1 else f"v{j}") for j in range(i % 4)},
             "n": {"ts": 1_700_000_000_000_000 + i}} for i in range(n)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_containers_cross_both_ways(tmp_path, codec):
    recs = _records()
    for writer, reader, name in ((pavro, javro, "p.avro"), (javro, pavro, "j.avro")):
        path = str(tmp_path / name)
        writer.write_container(path, AVRO_SCHEMA, recs, codec=codec)
        schema, got = reader.read_container(path)
        assert schema == AVRO_SCHEMA
        assert [{**r, "f": r["f"]} for r in got] == recs
    for r in recs:
        pe, je = pavro.Encoder(), javro.Encoder()
        pe.write(AVRO_SCHEMA, r)
        je.write(AVRO_SCHEMA, r)
        assert pe.out.getvalue() == je.out.getvalue()
        assert pavro.Decoder(pe.out.getvalue()).read(AVRO_SCHEMA) == r


def test_avro_refusals_equal_the_reference(tmp_path):
    bad = tmp_path / "bad.avro"
    bad.write_bytes(b"NOPE")
    _same_raise(javro.read_container, pavro.read_container, str(bad))
    _same_raise(javro.Decoder(b"\xff").long, pavro.Decoder(b"\xff").long)


_SCHEMA = [["year", "int", True], ["v", "long", True], ["tag", "string", True]]
_FILTERS = {
    "ge": {"kind": "call", "name": "greaterthanorequal",
           "children": [{"kind": "attr", "index": 0}, {"kind": "lit", "value": 2024,
                                                       "type": "int"}]},
    "eq_str": {"kind": "call", "name": "equalto",
               "children": [{"kind": "attr", "index": 2}, {"kind": "lit", "value": "b",
                                                           "type": "string"}]},
    "or": {"kind": "call", "name": "or", "children": [
        {"kind": "call", "name": "lessthan", "children": [
            {"kind": "attr", "index": 0}, {"kind": "lit", "value": 2023, "type": "int"}]},
        {"kind": "call", "name": "equalto", "children": [
            {"kind": "attr", "index": 0}, {"kind": "lit", "value": 2025, "type": "int"}]}]},
    "in": {"kind": "call", "name": "in", "children": [{"kind": "attr", "index": 0}],
           "values": [2022, 2024], "value_type": "int"},
    "not_in": {"kind": "call", "name": "in", "children": [{"kind": "attr", "index": 0}],
               "values": [2022], "value_type": "int", "negated": True},
    "null_lit": {"kind": "call", "name": "greaterthan",
                 "children": [{"kind": "attr", "index": 0}, {"kind": "lit", "value": None,
                                                             "type": "int"}]},
    "non_partition": {"kind": "call", "name": "lessthan",
                      "children": [{"kind": "attr", "index": 1}, {"kind": "lit", "value": 5,
                                                                  "type": "long"}]},
}
_PARTITIONS = [{"year": 2022, "tag": "a"}, {"year": 2024, "tag": "b"}, {"year": "2024"},
               {"year": None}, {}, {"year": 2025.0, "tag": "b"}]


@pytest.mark.parametrize("name", sorted(_FILTERS))
def test_file_pruning_equals_the_reference(name):
    je = jconvert_expr(_FILTERS[name], JConf())
    pe = pconvert_expr(_FILTERS[name], PConf())
    schema_j = jconvert({"op": "X", "schema": _SCHEMA, "children": []}).host_root.schema
    schema_p = pconvert({"op": "X", "schema": _SCHEMA, "children": []}).host_root.schema
    for part in _PARTITIONS:
        assert ptf._file_may_match(pe, schema_p, part) == jtf._file_may_match(je, schema_j, part)
    files = [{"path": f"/t/f{i}.parquet", "partition": p, "record_count": 1}
             for i, p in enumerate(_PARTITIONS)]
    for op in ("IcebergScanExec", "HudiScanExec", "PaimonScanExec"):
        plan = {"op": op, "schema": _SCHEMA,
                "args": {"files": files, "filters": [_FILTERS[name]]}, "children": []}
        want, got = jconvert(plan), pconvert(plan)
        assert got.tags.summary(got.host_root) == want.tags.summary(want.host_root)
        assert got.root.plan.SerializeToString() == want.root.plan.SerializeToString()


def test_parse_type_of_resolved_schemas(tmp_path):
    test_iceberg._build_table(str(tmp_path))
    for _, t, _ in piceberg.resolve_iceberg_scan(str(tmp_path))["schema"]:
        assert repr(parse_type(t)) == repr(jparse_type(t))
