"""Host-engine plan conversion (port of ``auron_tpu/convert/``). This slice
ports the stage split (``stages.py``): how a host schedules a plan segment
with exchanges as stage tasks. The converters of a host plan (``hostplan``,
``strategy``, ``exprs``, ``providers``, ``converters``, ``service``) and
the table formats are not ported yet (ROADMAP Queue 1 item 6)."""

from auron_tpu_torch.convert.stages import (
    ShuffleManager, StageSpec, ffi_reader_ids, provider_from_manifest, split_stages, stage_task,
)

__all__ = ["ShuffleManager", "StageSpec", "ffi_reader_ids", "provider_from_manifest",
           "split_stages", "stage_task"]
