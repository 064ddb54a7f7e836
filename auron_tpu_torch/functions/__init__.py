"""Scalar functions (port of ``auron_tpu/functions/``): ``registry`` holds
every function the planner's ``scalar_func`` node may name."""

from auron_tpu_torch.functions.registry import registry  # noqa: F401
import auron_tpu_torch.functions.extended  # noqa: F401,E402  (registers the long tail)
