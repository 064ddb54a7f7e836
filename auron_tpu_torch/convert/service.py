"""Engine-side conversion service for out-of-process hosts (port of
``auron_tpu/convert/service.py``).

The JVM shim ships its serialized physical plan (host-plan JSON) through
the C ABI (``auron_convert_plan``) and receives a segmentation response it
splices mechanically. Response JSON:

    {"converted": <bool — any native segment produced>,
     "root": <node>,
     "tags": [[op, ok, reason|null], ...]}           # walk_down order

    node := {"kind": "segment",
             "path": [child indexes RELATIVE to the parent response node],
             "plan_b64": <plan proto, base64>,
             "stages": [{"plan_b64": ..., "exchange_id": ...,
                         "num_output_partitions": ...,
                         "input_exchange_ids": [...],
                         "output_data_template": ..., "output_index_template": ...,
                         "ffi_input_ids": [...], "task_partitions": ...}, ...],
             "task_partitions": <int|null — task count pinned by the
                                 segment's scan file placement>,
             "schema": [[name, type, nullable], ...],
             "inputs": [{"resource_id": ..., "child": <node>} ...]}
          |  {"kind": "host", "path": [...], "op": ..., "children": [<node> ...]}

``stages`` is the host-schedulable split of the segment
(``convert/stages.py``); a segment with no exchange has one final stage.
Every error becomes ``{"converted": false, "error": ...}``: the shim must
never crash a query.
"""

from __future__ import annotations

import base64
import itertools
import json
import os

from auron_tpu_torch import types as T
from auron_tpu_torch.convert.converters import (
    ConversionResult, HostOp, NativeSegment, convert_plan,
)
from auron_tpu_torch.convert.hostplan import HostNode
from auron_tpu_torch.convert.stages import ffi_reader_ids, split_stages

# a conversion counter and the pid: stage exchange ids of queries converted
# concurrently, or by several driver processes feeding one executor, never
# collide on reduce-side shuffle resource keys
_conversion_seq = itertools.count()


def _namespace() -> str:
    return f"c{os.getpid()}_{next(_conversion_seq)}_"


def convert_host_plan_json(payload: bytes | str) -> bytes:
    try:
        res = convert_plan(payload if isinstance(payload, str) else payload.decode())
        return json.dumps(_response(res)).encode()
    except Exception as e:  # noqa: BLE001 — the shim must never crash a query
        return json.dumps({"converted": False, "error": f"{type(e).__name__}: {e}"}).encode()


def _b64(plan) -> str:
    return base64.b64encode(plan.SerializeToString()).decode()


def _response(res: ConversionResult) -> dict:
    paths: dict[int, list[int]] = {}

    def index(node: HostNode, path: list[int]) -> None:
        paths[id(node)] = path
        for i, c in enumerate(node.children):
            index(c, path + [i])

    index(res.host_root, [])
    any_native = [False]

    def host_of(n) -> HostNode:
        return n.host if isinstance(n, NativeSegment) else n.node

    def rel_path(n, parent_abs: list[int]) -> list[int]:
        return paths.get(id(host_of(n)), [])[len(parent_abs):]

    def emit(n, parent_abs: list[int]) -> dict:
        my_abs = paths.get(id(host_of(n)), [])
        if isinstance(n, NativeSegment):
            any_native[0] = True
            segment_rids = {rid for rid, _ in n.inputs}
            stages = [{
                "plan_b64": _b64(s.plan),
                "exchange_id": s.exchange_id,
                "num_output_partitions": s.num_output_partitions,
                "input_exchange_ids": s.input_exchange_ids,
                # {work_dir}/{partition} placeholders: the host derives a
                # task's shuffle-file paths by string substitution only
                "output_data_template": s.data_template,
                "output_index_template": s.index_template,
                # which of the segment's FFI inputs feed this stage
                "ffi_input_ids": [r for r in ffi_reader_ids(s.plan) if r in segment_rids],
                # a stage whose plan carries host-decided file groups runs
                # exactly that many tasks
                "task_partitions": _pinned_task_partitions(s.plan),
            } for s in split_stages(n.plan, namespace=_namespace())]
            return {
                "kind": "segment",
                "path": rel_path(n, parent_abs),
                "plan_b64": _b64(n.plan),
                "stages": stages,
                "task_partitions": _pinned_task_partitions(n.plan),
                "schema": [[f.name, _type_name(f.dtype), f.nullable] for f in n.schema],
                "inputs": [{"resource_id": rid, "child": emit(c, my_abs)}
                           for rid, c in n.inputs],
            }
        assert isinstance(n, HostOp)
        return {
            "kind": "host",
            "path": rel_path(n, parent_abs),
            "op": n.node.op,
            "children": [emit(c, my_abs) for c in n.children],
        }

    root = emit(res.root, [])
    return {"converted": any_native[0], "root": root,
            "tags": [[op, ok, why] for op, ok, why in res.tags.summary(res.host_root)]}


def _pinned_task_partitions(plan) -> int | None:
    """When a file scan carries host-decided per-task file groups, the task
    count is pinned to the group count (fewer tasks would drop groups)."""
    from auron_tpu_torch.plan.protowalk import child_nodes

    pinned: list[int] = []

    def rec(node):
        which = node.WhichOneof("plan")
        if which in ("parquet_scan", "orc_scan"):
            inner = getattr(node, which)
            if len(inner.partitions):
                pinned.append(len(inner.partitions))
        for c in child_nodes(node):
            rec(c)

    rec(plan)
    return max(pinned) if pinned else None


_TYPE_NAMES = {
    T.TypeKind.BOOL: "boolean", T.TypeKind.INT8: "byte", T.TypeKind.INT16: "short",
    T.TypeKind.INT32: "int", T.TypeKind.INT64: "long", T.TypeKind.FLOAT32: "float",
    T.TypeKind.FLOAT64: "double", T.TypeKind.STRING: "string", T.TypeKind.BINARY: "binary",
    T.TypeKind.DATE32: "date", T.TypeKind.TIMESTAMP: "timestamp", T.TypeKind.NULL: "null",
}


def _type_name(dtype: T.DataType) -> str:
    k = dtype.kind
    if k in _TYPE_NAMES:
        return _TYPE_NAMES[k]
    if k == T.TypeKind.DECIMAL:
        return f"decimal({dtype.precision},{dtype.scale})"
    if k == T.TypeKind.LIST:
        return f"array<{_type_name(dtype.inner[0])}>"
    if k == T.TypeKind.MAP:
        return f"map<{_type_name(dtype.inner[0])},{_type_name(dtype.inner[1])}>"
    if k == T.TypeKind.STRUCT:
        inner = ",".join(f"{n}:{_type_name(t)}" for n, t in zip(dtype.struct_names, dtype.inner))
        return f"struct<{inner}>"
    return str(k.value)
