"""Plan IR protobuf bindings: ``plan.proto`` and ``plan_pb2.py`` are
verbatim copies of ``auron_tpu/proto/`` (same serialized descriptor, so the
two load side by side in one process and share the descriptor pool; a copy
regenerated under another path would register duplicate symbols).

Nothing here imports ``plan_pb2`` eagerly: ``google.protobuf`` is needed
only by the code that decodes task bytes (``plan/planner.py``,
``runtime/task.py``)."""
