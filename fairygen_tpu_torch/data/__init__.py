from .operators import (
    DataProcessingOperator,
    DataProcessingPipeline,
    ToAbsolutePath,
    LoadImage,
    LoadVideo,
    LoadGIF,
    LoadNpz,
    ImageCropAndResize,
    RouteByType,
    RouteByExtensionName,
    SequencialProcess,
    ToList,
    ToInt,
    ToFloat,
    ToStr,
)
from .loader import PrefetchLoader
from .unified_dataset import UnifiedDataset
