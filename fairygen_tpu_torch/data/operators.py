"""Composable data operators (port of fairygen_tpu/data/operators.py).

Operators compose with ``>>`` into pipelines, as in the upstream DSL
(``animation/diffsynth/core/data/operators.py``).  Images and frames are
PIL images, as in the JAX package, so both give the same arrays; video
containers need imageio (imported at call time; a missing imageio raises);
preprocessed caches are ``.npz`` files.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np


class DataProcessingPipeline:
    def __init__(self, operators=None):
        self.operators: List["DataProcessingOperator"] = operators or []

    def __call__(self, data):
        for op in self.operators:
            data = op(data)
        return data

    def __rshift__(self, other):
        if isinstance(other, DataProcessingOperator):
            other = DataProcessingPipeline([other])
        return DataProcessingPipeline(self.operators + other.operators)


class DataProcessingOperator:
    def __call__(self, data):
        raise NotImplementedError

    def __rshift__(self, other):
        if isinstance(other, DataProcessingOperator):
            other = DataProcessingPipeline([other])
        return DataProcessingPipeline([self]).__rshift__(other)


class ToInt(DataProcessingOperator):
    def __call__(self, data):
        return int(data)


class ToFloat(DataProcessingOperator):
    def __call__(self, data):
        return float(data)


class ToStr(DataProcessingOperator):
    def __init__(self, none_value=""):
        self.none_value = none_value

    def __call__(self, data):
        return str(self.none_value if data is None else data)


class ToList(DataProcessingOperator):
    def __call__(self, data):
        return [data]


class ToAbsolutePath(DataProcessingOperator):
    def __init__(self, base_path=""):
        self.base_path = base_path

    def __call__(self, data):
        return os.path.join(self.base_path, data)


class LoadImage(DataProcessingOperator):
    def __init__(self, convert_RGB=True, convert_RGBA=False):
        self.convert_RGB = convert_RGB
        self.convert_RGBA = convert_RGBA

    def __call__(self, data: str):
        from PIL import Image

        image = Image.open(data)
        if self.convert_RGB:
            image = image.convert("RGB")
        if self.convert_RGBA:
            image = image.convert("RGBA")
        return image


class ImageCropAndResize(DataProcessingOperator):
    """Aspect-fill bilinear resize + center crop + division-factor rounding
    (reference operators.py:67-100)."""

    def __init__(self, height=None, width=None, max_pixels=None,
                 height_division_factor=1, width_division_factor=1):
        self.height = height
        self.width = width
        self.max_pixels = max_pixels
        self.height_division_factor = height_division_factor
        self.width_division_factor = width_division_factor

    def get_height_width(self, image):
        if self.height is None or self.width is None:
            width, height = image.size
            if width * height > self.max_pixels:
                scale = (width * height / self.max_pixels) ** 0.5
                height, width = int(height / scale), int(width / scale)
            height = height // self.height_division_factor * self.height_division_factor
            width = width // self.width_division_factor * self.width_division_factor
        else:
            height, width = self.height, self.width
        return height, width

    def __call__(self, image):
        from PIL import Image

        target_height, target_width = self.get_height_width(image)
        width, height = image.size
        scale = max(target_width / width, target_height / height)
        image = image.resize(
            (round(width * scale), round(height * scale)), Image.Resampling.BILINEAR
        )
        w, h = image.size
        left = (w - target_width) // 2
        top = (h - target_height) // 2
        return image.crop((left, top, left + target_width, top + target_height))


class SequencialProcess(DataProcessingOperator):
    def __init__(self, operator=lambda x: x):
        self.operator = operator

    def __call__(self, data):
        return [self.operator(i) for i in data]


def _shrink_to_remainder(n, factor, remainder):
    while n > 1 and n % factor != remainder:
        n -= 1
    return n


class LoadVideo(DataProcessingOperator):
    """Video container loader (requires imageio/ffmpeg at call time;
    reference operators.py:108-134)."""

    def __init__(self, num_frames=81, time_division_factor=4,
                 time_division_remainder=1, frame_processor=lambda x: x):
        self.num_frames = num_frames
        self.time_division_factor = time_division_factor
        self.time_division_remainder = time_division_remainder
        self.frame_processor = frame_processor

    def __call__(self, data: str):
        from PIL import Image

        try:
            import imageio

            reader = imageio.get_reader(data)
            total = int(reader.count_frames())
            n = self.num_frames
            if total < n:
                n = _shrink_to_remainder(total, self.time_division_factor,
                                         self.time_division_remainder)
            frames = []
            for i in range(n):
                frames.append(self.frame_processor(Image.fromarray(reader.get_data(i))))
            reader.close()
            return frames
        except ImportError as e:
            raise RuntimeError(
                "video container decoding requires imageio/ffmpeg; "
                "use frame directories or GIF/PNG inputs instead"
            ) from e


class LoadGIF(DataProcessingOperator):
    def __init__(self, num_frames=81, time_division_factor=4,
                 time_division_remainder=1, frame_processor=lambda x: x):
        self.num_frames = num_frames
        self.time_division_factor = time_division_factor
        self.time_division_remainder = time_division_remainder
        self.frame_processor = frame_processor

    def __call__(self, data: str):
        from PIL import Image, ImageSequence

        im = Image.open(data)
        raw = [f.convert("RGB") for f in ImageSequence.Iterator(im)]
        n = self.num_frames
        if len(raw) < n:
            n = _shrink_to_remainder(len(raw), self.time_division_factor,
                                     self.time_division_remainder)
        return [self.frame_processor(f) for f in raw[:n]]


class LoadFrameDir(DataProcessingOperator):
    """Directory of numbered frames -> list of PIL images (no container
    decoding)."""

    def __init__(self, num_frames=81, time_division_factor=4,
                 time_division_remainder=1, frame_processor=lambda x: x):
        self.num_frames = num_frames
        self.time_division_factor = time_division_factor
        self.time_division_remainder = time_division_remainder
        self.frame_processor = frame_processor

    def __call__(self, data: str):
        from PIL import Image

        files = sorted(
            f for f in os.listdir(data)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
        )
        n = self.num_frames
        if len(files) < n:
            n = _shrink_to_remainder(len(files), self.time_division_factor,
                                     self.time_division_remainder)
        return [
            self.frame_processor(Image.open(os.path.join(data, f)).convert("RGB"))
            for f in files[:n]
        ]


class RouteByExtensionName(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, data: str):
        ext = data.split(".")[-1].lower()
        for ext_names, operator in self.operator_map:
            if ext_names is None or ext in ext_names:
                return operator(data)
        raise ValueError(f"Unsupported file: {data}")


class RouteByType(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, data):
        for dtype, operator in self.operator_map:
            if dtype is None or isinstance(data, dtype):
                return operator(data)
        raise ValueError(f"Unsupported data: {data}")


class LoadNpz(DataProcessingOperator):
    """Cached preprocessed tensors (.npz replaces the reference's torch
    pickles — operators.py:198-203)."""

    def __call__(self, data):
        with np.load(data, allow_pickle=True) as z:
            out = {}
            for k in z.files:
                v = z[k]
                out[k] = v.item() if v.dtype == object and v.shape == () else v
            return out
