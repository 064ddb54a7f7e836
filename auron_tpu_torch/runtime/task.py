"""Per-task execution runtime: the batch pump (port of
``auron_tpu/runtime/task.py:TaskRuntime``).

A task is serialized ``TaskDefinition`` bytes (decoded by the port's own
proto3 codec, ``auron_tpu_torch.proto``), a decoded ``TaskDefinition``, or
an already-built exec tree; either way the tree runs whole-stage fused for
the task's device (``plan/fusion.py``). ``plan_info`` holds the task's
bytes, the seconds its decode took (bytes to message) and the seconds
``task_from_proto`` took (elision, pruning, planning, fusion), and the
metric snapshot of ``finalize`` carries it as ``"task"``.
The runtime drives the root operator on a background thread into a bounded
queue (a task started under the host's turn, ``runtime/dispatch.py``,
makes each batch under it, and its consumer gives the turn up while it
waits on the queue; any other task's pump runs without it), on the CUDA
stream that was current where the task started (a task slot's own stream
when tasks run concurrently);
the consumer pulls batches with ``next_batch`` (or host Arrow batches with
``next_arrow``, reference ``task.py:147-153``); an error anywhere in the
operator stream is re-raised on the consumer side; ``finalize`` cancels,
drains, joins the pump and returns the metric tree. Whichever way the
stream ends (its end, an error, a cancel), the pump unregisters every
memory consumer the task's operators registered and releases their spill
files (``memmgr.release_task_consumers``); ``finalize`` does so again in
case the pump never got there.

Observability (reference ``task.py:54-115``): the task's session-set obs
knobs apply before the pump starts (``obs.apply_conf``); the pump runs
under a task span whose parent is the caller's span and whose trace is
the one the conf's ``obs.trace.id`` names (the hand-off that keeps a task
started from another thread attributed to its query); each batch notes
``note_pump_batch``; ``finalize`` folds the metric tree into that trace.
The pump's log lines carry the task (``utils/logging.py``).

``StreamTaskRuntime`` (reference ``task.py:184``) pumps a continuous
pipeline (``auron_tpu_torch/stream``) instead: ``pipeline.step()`` until
stopped or exhausted, under one ``stream.<view>`` query trace, on a CUDA
stream of its own on the card; ``status()`` and ``stop(drain=)`` are its
surface (``serve/streams.py``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterator

import torch

from auron_tpu_torch import obs
from auron_tpu_torch.columnar.arrow_c import HostBatch
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext, TaskCancelled
from auron_tpu_torch.exec.metrics import MetricNode
from auron_tpu_torch.memory.memmgr import release_task_consumers
from auron_tpu_torch.runtime import dispatch
from auron_tpu_torch.utils.config import TOKIO_EQUIV_PREFETCH_DEPTH, Configuration, conf_scope

_END = object()


class TaskRuntime:
    def __init__(self, task, resources: dict | None = None, shared: dict | None = None,
                 stage_id: int = 0, partition_id: int = 0,
                 conf: Configuration | None = None, device: str = "cuda"):
        device = str(resolve_device(device))
        self.plan_info: dict | None = None
        if isinstance(task, ExecOperator):
            from auron_tpu_torch.plan.fusion import fuse_exec_tree

            conf = conf or Configuration()
            plan = fuse_exec_tree(task, conf, device)
        else:
            from auron_tpu_torch.plan.planner import decode_task, task_from_proto

            t0 = time.perf_counter()
            info = {"task_bytes": 0, "decode_s": 0.0}
            if isinstance(task, (bytes, bytearray, memoryview)):
                info["task_bytes"] = len(task)
                task = decode_task(task)
                info["decode_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            plan, stage_id, partition_id, conf = task_from_proto(task, device)
            info["plan_s"] = time.perf_counter() - t1
            self.plan_info = info
        self.plan = plan
        self.ctx = ExecutionContext(
            stage_id=stage_id, partition_id=partition_id, conf=conf,
            metrics=MetricNode(plan.name), resources=resources or {}, shared=shared,
            device=device,
        )
        # session-set obs knobs apply BEFORE the pump starts (a task that
        # carries obs.mode=trace would otherwise race its own mode switch);
        # the caller's span and the conf-threaded trace follow the pump
        obs.apply_conf(conf)
        self._obs_parent = obs.current_span()
        self._obs_trace = obs.get_trace(conf.get(obs.OBS_TRACE_ID))
        if self._obs_trace is None and self._obs_parent is not None:
            self._obs_trace = self._obs_parent.trace
        self._queue: queue.Queue = queue.Queue(maxsize=max(conf.get(TOKIO_EQUIV_PREFETCH_DEPTH), 1))
        self._error: BaseException | None = None
        self._finalized = False
        self._host_prefetch = False
        # the pump launches on the stream current where the task started: a
        # task slot's own stream (models/tpcds.run_tasks_parallel), else the
        # default stream
        self._stream = (torch.cuda.current_stream(torch.device(device))
                        if device.startswith("cuda") else None)
        # a task a served query starts takes turns with the other queries
        self._turn = dispatch.turn if dispatch.held() else contextlib.nullcontext
        self._thread = threading.Thread(target=self._pump, daemon=True, name="auron-torch-pump")
        self._thread.start()

    def _pump(self) -> None:
        from auron_tpu_torch.utils.logging import clear_task_context, set_task_context
        from auron_tpu_torch.utils.profiling import EngineCounters

        try:
            set_task_context(self.ctx.stage_id, self.ctx.partition_id)
            with conf_scope(self.ctx.conf), (torch.cuda.stream(self._stream)
                                             if self._stream is not None
                                             else contextlib.nullcontext()), obs.span(
                    f"task s{self.ctx.stage_id}p{self.ctx.partition_id}", cat="task",
                    parent=self._obs_parent, trace=self._obs_trace,
                    arg={"stage": self.ctx.stage_id, "partition": self.ctx.partition_id}):
                counters = EngineCounters._installed
                batches = self.plan.execute(self.ctx.partition_id, self.ctx)
                while True:
                    # each batch is made under the host's turn (if the task
                    # started under it), and handed over without it
                    with self._turn():
                        batch = next(batches, _END)
                        if batch is _END:
                            break
                        if counters is not None:
                            counters.note_batch()
                        obs.note_pump_batch()
                        if self._host_prefetch:
                            batch.prefetch_host()
                    self._queue.put(batch)
        except TaskCancelled:
            pass
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._error = e
        finally:
            clear_task_context()
            release_task_consumers(self.ctx)
            self._queue.put(_END)

    def _check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"task stage={self.ctx.stage_id} partition={self.ctx.partition_id} failed"
            ) from err

    def next_batch(self) -> Batch | None:
        """Next device batch, or None at end of stream."""
        if self._finalized:
            return None
        try:
            item = self._queue.get_nowait()
        except queue.Empty:
            with dispatch.waiting():
                item = self._queue.get()
        if item is _END:
            self._check_error()
            return None
        return item

    def next_arrow(self) -> HostBatch | None:
        """Next batch as a host Arrow batch (``Batch.to_host_arrow``), or None
        at end of stream: the host boundary. The first call switches the
        pump to start every later batch's device->host copy as it queues the
        batch, so the copy of batch n+1 overlaps the consumer's work on
        batch n. The root metric node's ``egress_time`` sums the time spent
        here turning batches into host Arrow."""
        self._host_prefetch = True
        b = self.next_batch()
        if b is None:
            return None
        with self.ctx.metrics.timer("egress_time"):
            return b.to_host_arrow()

    def __iter__(self) -> Iterator[Batch]:
        while (b := self.next_batch()) is not None:
            yield b

    def finalize(self) -> dict:
        """Cancel, drain, join; returns the metric-tree snapshot."""
        self._finalized = True
        self.ctx.cancel()
        deadline = 30.0
        with dispatch.waiting():  # the pump may wait for the turn
            while self._thread.is_alive() and deadline > 0:
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
                deadline -= 0.05
        release_task_consumers(self.ctx)
        self._check_error()
        snap = self.ctx.metrics.snapshot()
        fused = getattr(self.plan, "_fusion_plan", None)
        if fused is not None:
            snap["fusion"] = fused  # plan-time: segments fused, left eager by reason
        if self.plan_info is not None:
            snap["task"] = dict(self.plan_info)  # bytes, decode and planning seconds
        if self._obs_trace is not None:
            # the metric half of the span-vs-metrics cross-check
            self._obs_trace.add_task_metrics(snap)
        return snap


class StreamTaskRuntime:
    """Long-running pump of a continuous pipeline (``auron_tpu_torch/stream``;
    reference ``auron_tpu/runtime/task.py:184``): TaskRuntime's shape — one
    daemon thread owning the engine work, conf-scoped, its error relayed to
    the owner — but the loop is ``pipeline.step()`` until stopped or
    exhausted, and the surface is ``status()``/``stop()`` (emissions leave
    through the pipeline's sink).

    The whole stream runs under ONE query trace named ``stream.<view>``:
    the pipeline's emission and checkpoint spans attribute to it, and its
    summary lands on /queries when the stream ends. On the card the pump
    runs on a CUDA stream of its own, as a served query does; two pumps
    whose Calc chains share a graph key never capture it at once (the
    fusion graph cache captures and replays under one lock).

    ``_error``/``exhausted`` are written by the pump while it lives and by
    ``stop()`` only after joining it; ``status()`` readers never write.
    """

    def __init__(self, pipeline, name: str | None = None):
        self.pipeline = pipeline
        self.name = name or pipeline.plan.name
        obs.apply_conf(pipeline.conf)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self.exhausted = False
        dev = torch.device(pipeline.device)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._thread = threading.Thread(target=self._pump_stream, daemon=True,
                                        name=f"auron-torch-stream-{self.name}")
        self._thread.start()

    def _pump_stream(self) -> None:
        try:
            with conf_scope(self.pipeline.conf), (
                    torch.cuda.stream(self._stream) if self._stream is not None
                    else contextlib.nullcontext()), obs.query_trace(
                        f"stream.{self.name}", conf=self.pipeline.conf):
                while not self._stop.is_set():
                    if not self.pipeline.step():
                        self.exhausted = True
                        return
        except BaseException as e:  # noqa: BLE001 — relayed via status()/stop()
            self._error = e
        finally:
            if self._stream is not None:
                self._stream.synchronize()

    def status(self) -> dict:
        """Live stream state for /stream inspect: progress counters,
        watermark, and the error (if the pump died)."""
        p = self.pipeline
        return {
            "name": self.name,
            "alive": self._thread.is_alive(),
            "exhausted": self.exhausted,
            "steps": p.steps,
            "emit_seq": p.emit_seq,
            "watermark_ms": p.tracker.watermark_ms,
            "open_groups": len(p.store),
            "checkpoints": p.ckpt_seq,
            "metrics": dict(p.metrics),
            "error": repr(self._error) if self._error is not None else None,
        }

    def stop(self, timeout: float = 30.0, drain: bool = False) -> dict:
        """Stop the pump, close the pipeline, return the final status.
        ``drain=True`` force-closes all open windows first (finite sources,
        an orderly shutdown)."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        if drain and self._error is None and not self._thread.is_alive():
            self.pipeline.drain()
        try:
            self.pipeline.close()
        except BaseException as e:  # noqa: BLE001 — the pump's error takes precedence
            if self._error is None:
                self._error = e
        st = self.status()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"stream {self.name} failed") from err
        return st
