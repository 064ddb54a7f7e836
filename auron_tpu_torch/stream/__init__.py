"""Continuous streaming SQL (port of ``auron_tpu/stream``).

The batch engine's pieces composed into long-running pipelines:
``CREATE STREAMING VIEW`` texts (sql/parser.py ``parse_streaming_view``)
lower onto the existing streaming operators — Kafka source →
whole-stage-fused Calc chain (exec/streaming.py) → event-time windowed
grouped aggregation (host scatter state, the incremental
aggregate's shape) → watermark-driven emission → pluggable sink — with a
checkpoint coordinator that atomically snapshots source offsets +
window state so a killed pipeline resumes emission-for-emission
bit-identically (exactly-once output; tests/test_torch_stream_exactly_once.py
kills at every instrumented point and diffs).
"""

from auron_tpu_torch.stream.checkpoint import CheckpointCoordinator
from auron_tpu_torch.stream.lowering import StreamingPlan, lower_streaming_view
from auron_tpu_torch.stream.pipeline import StreamKilled, StreamPipeline
from auron_tpu_torch.stream.sink import CollectSink, JsonlFileSink, make_sink
from auron_tpu_torch.stream.state import WindowStore
from auron_tpu_torch.stream.windows import WatermarkTracker, WindowSpec

__all__ = [
    "CheckpointCoordinator", "CollectSink", "JsonlFileSink", "StreamKilled",
    "StreamPipeline", "StreamingPlan", "WatermarkTracker", "WindowSpec",
    "WindowStore", "lower_streaming_view", "make_sink",
]
