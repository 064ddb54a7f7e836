"""Engine logging with task context (port of ``auron_tpu/utils/logging.py``,
verbatim but for the imports).

Analog of the reference's native logging (native-engine/auron/src/
logging.rs:90-130): structured lines carrying (stage, partition) pulled
from task-scoped context, level from configuration (NATIVE_LOG_LEVEL,
conf.rs:64). The task runtime installs the context for its pump thread.
"""

from __future__ import annotations

import logging
import threading

from auron_tpu_torch.utils.config import NATIVE_LOG_LEVEL, active_conf

_ctx = threading.local()


def set_task_context(stage_id: int, partition_id: int) -> None:
    _ctx.stage = stage_id
    _ctx.partition = partition_id


def clear_task_context() -> None:
    _ctx.stage = None
    _ctx.partition = None


class _TaskContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        stage = getattr(_ctx, "stage", None)
        part = getattr(_ctx, "partition", None)
        record.task = f"[stage={stage} partition={part}]" if stage is not None else ""
        return True


_configured = False


def get_logger(name: str = "auron_tpu_torch") -> logging.Logger:
    global _configured
    log = logging.getLogger(name)
    if not _configured:
        level = active_conf().get(NATIVE_LOG_LEVEL).upper()
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(task)s %(message)s")
        )
        handler.addFilter(_TaskContextFilter())
        root = logging.getLogger("auron_tpu_torch")
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.INFO))
        _configured = True
    return log
