"""The port's proto3 codec (``auron_tpu_torch/proto/wire.py``) against
``google.protobuf`` and the reference's ``plan_pb2``, exact throughout.

- every message type of ``plan.proto``: seeded random instances built the
  same way in both (edge values: a oneof member at its default, empty
  sub-messages that are present, maps (their deterministic entry order is
  upb's: integer keys descending, string keys a key before its prefixes),
  negative int32/int64, sint64 at
  both ends, uint64 at 2^64 - 1, NaN, -0.0 and infinite doubles, bytes
  with zero bytes, non-ASCII strings, unknown enum numbers). The port's
  bytes equal ``SerializeToString(deterministic=True)``, the port decodes
  the reference's bytes and re-encodes them unchanged, the reference
  parses what the port builds into an equal message, and the two agree on
  ``ListFields``, ``WhichOneof`` and ``HasField``;
- unpacked repeated scalars, unknown fields (every wire type, groups
  included), a known field sent with another wire type, a scalar sent
  twice and a sub-message sent twice read as the reference reads them;
- malformed input raises ``ValueError`` and leaves the message unchanged;
- the TaskDefinitions the JAX package's q42, q93, q3, q72, q95 and
  generate classes send to its bridge decode in the port, re-encode to the
  deterministic bytes, and plan (``task_from_proto``) into the same tree as
  the reference's ``plan_pb2`` messages of the same bytes.
"""

import math

import numpy as np
import pytest

from auron_tpu.proto import plan_pb2 as G

from auron_tpu_torch import proto as P
from auron_tpu_torch.plan import explain as pexplain
from auron_tpu_torch.plan import planner as pplanner

FD = G.DESCRIPTOR.message_types_by_name["DataType"].fields_by_name["kind"].__class__


def _all_types(descs):
    for d in descs:
        if d.GetOptions().map_entry:
            continue
        yield d
        yield from _all_types(d.nested_types)


TYPES = sorted(d.full_name for d in _all_types(G.DESCRIPTOR.message_types_by_name.values()))


def _classes(full_name: str):
    parts = full_name.split(".")[1:]
    g, p = G, P
    for part in parts:
        g, p = getattr(g, part), getattr(p, part)
    return g, p


_EDGES = {
    FD.TYPE_INT64: [0, 1, -1, 2**63 - 1, -(2**63)],
    FD.TYPE_SINT64: [0, 1, -1, 2**63 - 1, -(2**63)],
    FD.TYPE_UINT64: [0, 1, 2**63, 2**64 - 1],
    FD.TYPE_INT32: [0, 1, -1, 2**31 - 1, -(2**31)],
    FD.TYPE_UINT32: [0, 1, 2**32 - 1],
    FD.TYPE_DOUBLE: [0.0, -0.0, math.nan, math.inf, -math.inf, 5e-324, 1.5],
    FD.TYPE_BOOL: [False, True],
    FD.TYPE_STRING: ["", "a", "héllo ✓ 漢字", "\x00z", "\U0001f600"],
    FD.TYPE_BYTES: [b"", b"\x00", b"\x00\xff\x00abc"],
}
_RANGES = {FD.TYPE_INT64: (-(2**63), 2**63 - 1), FD.TYPE_SINT64: (-(2**63), 2**63 - 1),
           FD.TYPE_UINT64: (0, 2**64 - 1), FD.TYPE_INT32: (-(2**31), 2**31 - 1),
           FD.TYPE_UINT32: (0, 2**32 - 1)}


def _value(rng, fd):
    t = fd.type
    if t == FD.TYPE_ENUM:
        vals = [v.number for v in fd.enum_type.values]
        return int(rng.choice(vals + [99, -1])) if rng.random() < 0.2 else int(rng.choice(vals))
    if rng.random() < 0.5:
        edges = _EDGES[t]
        return edges[int(rng.integers(len(edges)))]
    if t in _RANGES:
        lo, hi = _RANGES[t]
        return int(rng.integers(lo, hi, endpoint=True, dtype=np.int64 if lo < 0 else np.uint64))
    if t == FD.TYPE_DOUBLE:
        return float(rng.normal() * 10.0 ** int(rng.integers(-300, 300)))
    if t == FD.TYPE_BOOL:
        return bool(rng.integers(2))
    if t == FD.TYPE_STRING:
        return "".join(chr(int(c)) for c in rng.integers(1, 0x3000, int(rng.integers(0, 6))))
    return bytes(rng.integers(0, 256, int(rng.integers(0, 6))).astype(np.uint8))


def _fill(g, p, desc, rng, depth: int) -> None:
    """Set the same random fields on the reference message ``g`` and the
    port's message ``p``."""
    for fd in desc.fields:
        if fd.containing_oneof is not None or rng.random() < 0.35:
            continue
        gv, pv = getattr(g, fd.name), getattr(p, fd.name)
        if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
            kf, vf = fd.message_type.fields_by_name["key"], fd.message_type.fields_by_name["value"]
            for _ in range(int(rng.integers(0, 4))):
                k, v = _value(rng, kf), _value(rng, vf)
                gv[k] = v
                pv[k] = v
        elif fd.is_repeated:
            for _ in range(int(rng.integers(0, 3))):
                if fd.type == FD.TYPE_MESSAGE:
                    if depth < 3:
                        _fill(gv.add(), pv.add(), fd.message_type, rng, depth + 1)
                else:
                    v = _value(rng, fd)
                    gv.append(v)
                    pv.append(v)
        elif fd.type == FD.TYPE_MESSAGE:
            if depth >= 3 or rng.random() < 0.3:
                gv.SetInParent()  # present and empty
                pv.SetInParent()
            else:
                _fill(gv, pv, fd.message_type, rng, depth + 1)
        else:
            v = _value(rng, fd)
            setattr(g, fd.name, v)
            setattr(p, fd.name, v)
    for o in desc.oneofs:
        if rng.random() < 0.2:
            continue
        fd = o.fields[int(rng.integers(len(o.fields)))]
        if fd.type == FD.TYPE_MESSAGE:
            if depth >= 3 or rng.random() < 0.3:
                getattr(g, fd.name).SetInParent()
                getattr(p, fd.name).SetInParent()
            else:
                _fill(getattr(g, fd.name), getattr(p, fd.name), fd.message_type, rng, depth + 1)
        else:  # a member at its default stays set
            v = _value(rng, fd) if rng.random() < 0.7 else type(_value(rng, fd))()
            setattr(g, fd.name, v)
            setattr(p, fd.name, v)


def _det(m) -> bytes:
    return m.SerializeToString(deterministic=True)


@pytest.mark.parametrize("name", TYPES)
def test_random_messages_match_the_reference(name):
    gcls, pcls = _classes(name)
    desc = gcls.DESCRIPTOR
    rng = np.random.default_rng(TYPES.index(name) + 7)
    for _ in range(12):
        g, p = gcls(), pcls()
        _fill(g, p, desc, rng, 0)
        want = _det(g)
        assert p.SerializeToString() == want
        back = pcls.FromString(want)
        assert back.SerializeToString() == want and back == p
        assert gcls.FromString(p.SerializeToString()) == g
        assert [f.name for f, _ in p.ListFields()] == [f.name for f, _ in g.ListFields()]
        for o in desc.oneofs:
            assert p.WhichOneof(o.name) == g.WhichOneof(o.name)
        for fd in desc.fields:
            if fd.type == FD.TYPE_MESSAGE and not fd.is_repeated:
                assert p.HasField(fd.name) == g.HasField(fd.name)
        assert p.ByteSize() == g.ByteSize()


def test_module_reads_as_plan_pb2():
    """Every public name of ``plan_pb2`` is on the port's module: the
    message classes by name, enum wrappers with ``Name``/``Value`` and the
    enum values (top-level on the module, nested on their class)."""
    names = [n for n in dir(G) if not n.startswith("_") and n != "DESCRIPTOR"]
    for n in names:
        assert hasattr(P, n), n
        gv = getattr(G, n)
        if isinstance(gv, int):
            assert getattr(P, n) == gv, n
    for e in G.DESCRIPTOR.enum_types_by_name.values():
        for v in e.values:
            assert getattr(P, e.name).Name(v.number) == v.name
            assert getattr(P, e.name).Value(v.name) == v.number
    assert P.Partitioning.HASH == G.Partitioning.HASH
    assert P.DataType.Kind.Name(5) == G.DataType.Kind.Name(5) == "INT64"
    assert P.DataType.DECIMAL == G.DataType.DECIMAL
    m = P.LiteralExpr(dtype=P.DataType(kind=P.DataType.DECIMAL, precision=7, scale=2),
                      decimal_unscaled=-(2**63))
    g = G.LiteralExpr(dtype=G.DataType(kind=G.DataType.DECIMAL, precision=7, scale=2),
                      decimal_unscaled=-(2**63))
    assert m.SerializeToString() == _det(g)


def test_message_api_errors_match_the_reference():
    p, g = P.ProjectNode(), G.ProjectNode()
    for obj in (p, g):
        with pytest.raises(ValueError):
            obj.HasField("exprs")  # repeated: no presence
        with pytest.raises(ValueError):
            obj.HasField("nope")
        with pytest.raises(AttributeError):
            obj.child = P.PhysicalPlanNode() if obj is p else G.PhysicalPlanNode()
        with pytest.raises(AttributeError):
            obj.exprs = []
    d = P.DataType()
    with pytest.raises(ValueError):
        d.precision = -1
    with pytest.raises(ValueError):
        d.precision = 2**32
    with pytest.raises(TypeError):
        d.precision = 1.0
    with pytest.raises(TypeError):
        P.LiteralExpr().bytes_value = "x"
    # a sub-message read is absent until written; writing it sets its oneof
    n = P.PhysicalPlanNode()
    proj = n.project
    assert n.WhichOneof("plan") is None and not n.HasField("project")
    proj.exprs.add().name = "x"
    assert n.WhichOneof("plan") == "project"
    n.filter.SetInParent()
    assert n.WhichOneof("plan") == "filter" and not n.HasField("project")
    n.ClearField("plan")
    assert n.WhichOneof("plan") is None and n.SerializeToString() == b""


def _tag(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _varint(v: int) -> bytes:
    v &= 2**64 - 1
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _clean(gmsg) -> bytes:
    gmsg.DiscardUnknownFields()
    return _det(gmsg)


@pytest.mark.parametrize("cls,number,values", [
    ("Partitioning", 5, [0, 1, 2**64 - 1, 7]),      # range_bound_words, uint64
    ("GenerateNode", 4, [3, 0, 2**32 - 1]),          # required_cols, uint32
    ("KafkaScanNode", 8, [1, 2, 3]),                 # pb_field_ids
])
def test_unpacked_repeated_scalars_read(cls, number, values):
    unpacked = b"".join(_tag(number, 0) + _varint(v) for v in values)
    packed_half = _tag(number, 2) + _varint(len(b"".join(map(_varint, values[:1])))) + \
        _varint(values[0])
    for wire in (unpacked, packed_half + unpacked):
        got, want = getattr(P, cls).FromString(wire), getattr(G, cls).FromString(wire)
        assert got.SerializeToString() == _det(want)
        assert list(getattr(got, got.DESCRIPTOR.fields_by_number[number].name)) == \
            list(getattr(want, want.DESCRIPTOR.fields_by_number[number].name))


_UNKNOWN = (_tag(99, 0) + _varint(2**64 - 1) + _tag(100, 1) + b"\x01" * 8
            + _tag(101, 2) + _varint(3) + b"abc" + _tag(102, 5) + b"\x02" * 4
            + _tag(103, 3) + _tag(1, 0) + _varint(5) + _tag(2, 2) + b"\x01z" + _tag(103, 4))


def test_unknown_fields_and_wrong_wire_types_are_skipped():
    g = G.PhysicalExprNode()
    g.column.index = 4
    g.column.name = "c"
    base = _det(g)
    # ColumnExpr.index (a varint) sent length-delimited reads as unknown
    inner = _tag(1, 2) + b"\x01x" + _tag(2, 2) + b"\x00"
    for wire in (_UNKNOWN + base, base + _UNKNOWN, _tag(1, 2) + _varint(len(inner)) + inner):
        got = P.PhysicalExprNode.FromString(wire)
        assert got.SerializeToString() == _clean(G.PhysicalExprNode.FromString(wire))


def test_repeated_scalar_keeps_the_last_and_messages_merge():
    cases = [
        (P.ColumnExpr, G.ColumnExpr, _tag(1, 0) + _varint(3) + _tag(1, 0) + _varint(7)),
        # column sent twice: {index 1} then {name "x"} merge
        (P.PhysicalExprNode, G.PhysicalExprNode,
         _tag(1, 2) + b"\x02\x08\x01" + _tag(1, 2) + b"\x03\x12\x01x"),
        # a oneof: int_value then string_value -> string_value
        (P.LiteralExpr, G.LiteralExpr, _tag(4, 0) + _varint(-5) + _tag(6, 2) + b"\x02hi"),
        # a oneof message member replaced by another member, then back
        (P.PhysicalExprNode, G.PhysicalExprNode,
         _tag(1, 2) + b"\x02\x08\x01" + _tag(15, 2) + b"\x00" + _tag(1, 2) + b"\x02\x08\x02"),
        # map entries: the last value of a key wins, missing key/value default
        (P.TaskDefinition, G.TaskDefinition,
         _tag(4, 2) + b"\x06\x0a\x01a\x12\x01x" + _tag(4, 2) + b"\x06\x0a\x01a\x12\x01y"
         + _tag(4, 2) + b"\x03\x12\x01v" + _tag(4, 2) + b"\x00"),
    ]
    for pcls, gcls, wire in cases:
        got, want = pcls.FromString(wire), gcls.FromString(wire)
        assert got.SerializeToString() == _det(want), wire
        assert [f.name for f, _ in got.ListFields()] == [f.name for f, _ in want.ListFields()]
    t = P.TaskDefinition.FromString(cases[-1][2])
    assert dict(t.conf) == dict(G.TaskDefinition.FromString(cases[-1][2]).conf)


_MALFORMED = [
    (P.ColumnExpr, b"\x08\x80"),                            # truncated varint
    (P.ColumnExpr, b"\x08" + b"\xff" * 10 + b"\x01"),       # varint past 10 bytes
    (P.ColumnExpr, b"\x12\x05ab"),                          # length past the end
    (P.ColumnExpr, b"\x0e"),                                # wire type 6
    (P.ColumnExpr, b"\x0f"),                                # wire type 7
    (P.ColumnExpr, b"\x00\x01"),                            # field number 0
    (P.ColumnExpr, b"\x12\x02\xff\xfe"),                    # invalid UTF-8
    (P.ColumnExpr, b"\x0c"),                                # end-group without a start
    (P.LiteralExpr, b"\x29\x00\x00"),                       # truncated fixed64
    (P.PhysicalExprNode, b"\x0a\x02\x08\x80"),              # nested truncated varint
    (P.PhysicalExprNode, b"\x0a\x05\x08\x01"),              # nested length past the end
    (P.Partitioning, b"\x2a\x02\x01\x80"),                  # packed varint cut short
    (P.TaskDefinition, b"\x22\x04\x0a\x05abc"),             # map entry overrun
    (P.ColumnExpr, b"\x1b\x08\x01"),                        # unterminated group
]


@pytest.mark.parametrize("case", range(len(_MALFORMED)))
def test_malformed_input_raises_and_changes_nothing(case):
    pcls, wire = _MALFORMED[case]
    gcls = getattr(G, pcls.DESCRIPTOR.name)
    with pytest.raises(Exception):
        gcls.FromString(wire)  # the reference refuses it too
    with pytest.raises(ValueError):
        pcls.FromString(wire)
    m = pcls()
    m.ParseFromString(pcls().SerializeToString())
    before = m.SerializeToString()
    with pytest.raises(ValueError):
        m.ParseFromString(wire)
    assert m.SerializeToString() == before


# ---------------------------------------------------------------------------
# the JAX package's own TaskDefinitions
# ---------------------------------------------------------------------------

_CLASSES = ("q42", "q93", "q3", "q72", "q95", "generate")


@pytest.fixture(scope="module")
def jax_tasks(tmp_path_factory):
    """The serialized TaskDefinitions each JAX class hands its bridge's
    ``call_native``, captured by patching it, at SF 0.005."""
    from auron_tpu.bridge import api as japi
    from auron_tpu.models import tpcds as jt

    data = jt.generate(0.005, 42)
    work = tmp_path_factory.mktemp("jax_tasks")
    runs = {
        "q42": lambda: jt.run_q42_class(data),
        "q93": lambda: jt.run_q93_class(data, n_map=2, n_reduce=2, work_dir=str(work / "q93")),
        "q3": lambda: jt.run_q3_class(data, n_map=2, n_reduce=2, work_dir=str(work / "q3")),
        "q72": lambda: jt.run_q72_class(data, n_map=2, n_reduce=2, work_dir=str(work / "q72")),
        "q95": lambda: jt.run_q95_class(data, n_map=2, n_reduce=2, work_dir=str(work / "q95")),
        "generate": lambda: jt.run_generate_class(data),
    }
    captured: dict = {}
    real = japi.call_native
    with pytest.MonkeyPatch.context() as mp:
        for name, run in runs.items():
            def record(task_bytes, extra_resources=None, _name=name):
                captured.setdefault(_name, []).append(bytes(task_bytes))
                return real(task_bytes, extra_resources)

            mp.setattr(japi, "call_native", record)
            run()
    return captured


@pytest.mark.parametrize("name", _CLASSES)
def test_jax_task_definitions_decode_and_plan_alike(jax_tasks, name):
    tasks = jax_tasks[name]
    assert tasks, name
    for b in tasks:
        want = G.TaskDefinition.FromString(b)
        port = P.TaskDefinition.FromString(b)
        assert port.SerializeToString() == _det(want)
        assert P.TaskDefinition.FromString(_det(want)) == port
        got_tree, *got_rest = pplanner.task_from_proto(port, "cpu")
        ref_tree, *ref_rest = pplanner.task_from_proto(G.TaskDefinition.FromString(b), "cpu")
        assert pexplain.explain(got_tree) == pexplain.explain(ref_tree)
        assert got_rest[:2] == ref_rest[:2]
        assert got_rest[2].items() == ref_rest[2].items()
