"""Concurrent multi-tenant SQL serving (port of ``auron_tpu/serve/``).

The server around the engine: ``SqlServer`` executes many queries
concurrently on one card — each under its own query trace, per-tenant
session conf and CUDA stream — with a plan-digest-keyed compiled-plan
cache above the fusion stage cache (serve/cache.py) and an admission layer
with memory-manager-aware backpressure (serve/admission.py).
``utils/httpsvc`` exposes it at ``POST /sql``; ``models/servegate.py`` is
the concurrency differential gate. The reference's stream server
(``serve/streams.py``) comes with the port of ``stream/``.
"""

from auron_tpu_torch.serve.admission import AdmissionController, AdmissionTimeout
from auron_tpu_torch.serve.cache import PlanCache
from auron_tpu_torch.serve.server import QueryError, SqlServer

__all__ = [
    "AdmissionController",
    "AdmissionTimeout",
    "PlanCache",
    "QueryError",
    "SqlServer",
]
