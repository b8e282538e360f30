"""Part of the fairygen_tpu_torch port (mirrors fairygen_tpu)."""
from .unipc import UniPCMultistepScheduler, UniPCState  # noqa: F401
