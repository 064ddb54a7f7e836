"""memory layer of the port: the device-memory budget and the spill tiers."""

from auron_tpu_torch.memory.memmgr import MemConsumer, MemManager  # noqa: F401
