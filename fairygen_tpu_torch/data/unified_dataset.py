"""UnifiedDataset: csv/json/jsonl metadata and operator-driven loading
(port of fairygen_tpu/data/unified_dataset.py).

Per-key operators, ``repeat``, and a cached-tensor mode (``.npz`` files,
found in sorted order under ``base_path`` when ``metadata_path`` is None)
for two-phase data_process -> train runs.  Indexable; pair it with
:class:`~fairygen_tpu_torch.data.loader.PrefetchLoader` or a plain loop.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, Optional, Sequence

from .operators import (
    ImageCropAndResize,
    LoadGIF,
    LoadImage,
    LoadNpz,
    LoadVideo,
    LoadFrameDir,
    RouteByExtensionName,
    RouteByType,
    SequencialProcess,
    ToAbsolutePath,
    ToList,
)


class UnifiedDataset:
    def __init__(
        self,
        base_path: Optional[str] = None,
        metadata_path: Optional[str] = None,
        repeat: int = 1,
        data_file_keys: Sequence[str] = (),
        main_data_operator: Callable = lambda x: x,
        special_operator_map: Optional[Dict[str, Callable]] = None,
    ):
        self.base_path = base_path
        self.metadata_path = metadata_path
        self.repeat = repeat
        self.data_file_keys = tuple(data_file_keys)
        self.main_data_operator = main_data_operator
        self.cached_data_operator = LoadNpz()
        self.special_operator_map = special_operator_map or {}
        self.data = []
        self.cached_data = []
        self.load_from_cache = metadata_path is None
        self._load_metadata(metadata_path)

    # ------------------------------------------------------------- defaults
    @staticmethod
    def default_image_operator(base_path="", max_pixels=1920 * 1080, height=None,
                               width=None, height_division_factor=16,
                               width_division_factor=16):
        crop = ImageCropAndResize(height, width, max_pixels,
                                  height_division_factor, width_division_factor)
        return RouteByType([
            (str, ToAbsolutePath(base_path) >> LoadImage() >> crop),
            (list, SequencialProcess(ToAbsolutePath(base_path) >> LoadImage() >> crop)),
        ])

    @staticmethod
    def default_video_operator(base_path="", max_pixels=1920 * 1080, height=None,
                               width=None, height_division_factor=16,
                               width_division_factor=16, num_frames=81,
                               time_division_factor=4, time_division_remainder=1):
        crop = ImageCropAndResize(height, width, max_pixels,
                                  height_division_factor, width_division_factor)
        return RouteByType([
            (str, ToAbsolutePath(base_path) >> RouteByExtensionName([
                (("jpg", "jpeg", "png", "webp"), LoadImage() >> crop >> ToList()),
                (("gif",), LoadGIF(num_frames, time_division_factor,
                                   time_division_remainder, frame_processor=crop)),
                (("mp4", "avi", "mov", "wmv", "mkv", "flv", "webm"),
                 LoadVideo(num_frames, time_division_factor,
                           time_division_remainder, frame_processor=crop)),
                (None, LoadFrameDir(num_frames, time_division_factor,
                                    time_division_remainder, frame_processor=crop)),
            ])),
        ])

    # ------------------------------------------------------------- metadata
    def _search_cached(self, path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub):
                self._search_cached(sub)
            elif sub.endswith(".npz"):
                self.cached_data.append(sub)

    def _load_metadata(self, metadata_path):
        if metadata_path is None:
            self._search_cached(self.base_path)
        elif metadata_path.endswith(".json"):
            with open(metadata_path) as f:
                self.data = json.load(f)
        elif metadata_path.endswith(".jsonl"):
            with open(metadata_path) as f:
                self.data = [json.loads(line) for line in f if line.strip()]
        else:
            with open(metadata_path, newline="") as f:
                self.data = list(csv.DictReader(f))

    # ------------------------------------------------------------- access
    def __getitem__(self, idx):
        if self.load_from_cache:
            return self.cached_data_operator(self.cached_data[idx % len(self.cached_data)])
        data = dict(self.data[idx % len(self.data)])
        for key in self.data_file_keys:
            if key in data:
                op = self.special_operator_map.get(key, self.main_data_operator)
                data[key] = op(data[key])
        return data

    def __len__(self):
        n = len(self.cached_data) if self.load_from_cache else len(self.data)
        return n * self.repeat

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
