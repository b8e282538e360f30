"""Image/video pre- and post-processing (port of fairygen_tpu/core/imaging.py).

Value mapping ``x*2/255 - 1`` in and ``(x+1)*255/2`` clipped out, and the
shape rounding, are those of the JAX package (upstream
base_pipeline.py:95-143).  Host-side numpy.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def check_resize_height_width(
    height: int,
    width: int,
    num_frames: Optional[int] = None,
    height_division_factor: int = 32,
    width_division_factor: int = 32,
    time_division_factor: int = 4,
    time_division_remainder: int = 1,
):
    """Round shapes up to the model's division factors."""
    if height % height_division_factor != 0:
        height = _round_up(height, height_division_factor)
    if width % width_division_factor != 0:
        width = _round_up(width, width_division_factor)
    if num_frames is None:
        return height, width
    if num_frames % time_division_factor != time_division_remainder:
        num_frames = _round_up(num_frames, time_division_factor) + time_division_remainder
    return height, width, num_frames


def preprocess_image(image, min_value=-1.0, max_value=1.0) -> np.ndarray:
    """PIL.Image (or HWC uint8 array) -> float32 CHW in [min, max]."""
    arr = np.asarray(image, dtype=np.float32)
    arr = arr * ((max_value - min_value) / 255.0) + min_value
    return np.transpose(arr, (2, 0, 1))


def preprocess_video(video: List, min_value=-1.0, max_value=1.0) -> np.ndarray:
    """Frames (PIL images or HWC uint8 arrays) -> float32 (1, C, T, H, W)."""
    frames = [preprocess_image(im, min_value, max_value) for im in video]
    return np.stack(frames, axis=1)[None]


def postprocess_image(arr: np.ndarray, min_value=-1.0, max_value=1.0) -> np.ndarray:
    """float (C, H, W) or (H, W, C) in [min, max] -> uint8 HWC."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))
    arr = (arr - min_value) * (255.0 / (max_value - min_value))
    return np.clip(arr, 0, 255).astype(np.uint8)


def postprocess_video(arr: np.ndarray, min_value=-1.0, max_value=1.0) -> List[np.ndarray]:
    """float (B, C, T, H, W) -> list of uint8 HWC frames (batch mean)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 5:
        arr = arr.mean(axis=0)
    arr = np.transpose(arr, (1, 2, 3, 0))
    return [postprocess_image(f, min_value, max_value) for f in arr]
