"""The plan IR: ``plan.proto`` (a verbatim copy of
``auron_tpu/proto/plan.proto``) and its message classes, which the port's
own proto3 codec (``wire.py``) makes from the file at first use; nothing
here needs ``google.protobuf``.

The module reads as ``protoc``'s ``plan_pb2`` does::

    from auron_tpu_torch import proto as pb
    t = pb.TaskDefinition(plan=pb.PhysicalPlanNode(...), stage_id=1)
    pb.TaskDefinition.FromString(t.SerializeToString())
    pb.AGG_SUM, pb.Partitioning.HASH, pb.DataType.Kind.Name(5)
"""

from __future__ import annotations

import importlib
import os
import threading

PROTO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plan.proto")

_lock = threading.Lock()
_schema = None


def schema():
    """The namespace of ``plan.proto``'s message classes and enums, loaded once."""
    global _schema
    with _lock:
        if _schema is None:
            _schema = importlib.import_module(f"{__name__}.wire").load(PROTO_PATH)
    return _schema


def __getattr__(name: str):
    if name.startswith("__") or name == "wire":
        raise AttributeError(name)
    try:
        return getattr(schema(), name)
    except AttributeError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
