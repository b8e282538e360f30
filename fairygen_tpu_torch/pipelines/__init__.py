"""Part of the fairygen_tpu_torch port (mirrors fairygen_tpu)."""
from .sd15_brushnet import SD15BrushNetPipeline, blend_with_original  # noqa: F401
