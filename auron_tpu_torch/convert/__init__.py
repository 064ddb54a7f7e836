"""Host-engine plan conversion (L2; port of ``auron_tpu/convert/``).

A host engine's shim dumps its physical plan as host-plan JSON; this
package tags it, lowers every maximal convertible subtree into one native
plan, and splits each such segment into host-schedulable stages:

- hostplan:   the neutral host-plan tree format
- exprs:      host expression -> engine IR, with host-UDF fallback wrapping
- strategy:   bottom-up convertibility tagging + per-operator enable flags
              + the inefficient-convert fixpoint
- providers:  the provider SPI (table formats: table_formats, hudi,
              iceberg, paimon)
- converters: per-operator proto builders + maximal-subtree segmentation
- service:    the segmentation response of ``bridge.api.convert_plan_json``
- stages:     the stage split and the shuffle-manager contract
"""

from auron_tpu_torch.convert.converters import ConversionResult, convert_plan
from auron_tpu_torch.convert.hostplan import HostNode
from auron_tpu_torch.convert.stages import (
    ShuffleManager, StageSpec, ffi_reader_ids, provider_from_manifest, split_stages, stage_task,
)
from auron_tpu_torch.convert.strategy import ConvertTags

__all__ = ["ConversionResult", "ConvertTags", "HostNode", "ShuffleManager", "StageSpec",
           "convert_plan", "ffi_reader_ids", "provider_from_manifest", "split_stages",
           "stage_task"]
