"""Hash-keyed model registry (port of fairygen_tpu/core/registry.py).

A checkpoint's architecture is found from the md5 of its sorted
``key:shape`` strings (``core.io.hash_model_file``) in the upstream
74-entry table, kept as data in ``configs/model_registry.json`` (the
port's own copy).  Each ``model_name`` maps to a builder
``(state_dict, extra_kwargs, dtype, device) -> (params, config)``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

from .io import hash_model_file, load_state_dict

# Wan registry names the JAX package's pool builds nothing for: the
# pipeline takes them as constructor arguments
_POOLLESS = {"wan_video_vace": "vace_params", "wan_video_motion_controller":
             "motion_controller_params", "wan_video_image_encoder": "image_encoder_params",
             "wan_video_vap": "vap_params", "wan_video_animate_adapter": "animate_params"}
_REGISTRY_JSON = os.path.join(os.path.dirname(__file__), "..", "configs", "model_registry.json")


@dataclasses.dataclass
class ModelSpec:
    model_hash: str
    model_name: str
    extra_kwargs: Dict[str, Any]
    # the upstream converter's name, for information: builders pick their
    # converter from the model name and the state dict's layout
    source_converter: Optional[str] = None


class ModelRegistry:
    def __init__(self, specs: Optional[List[ModelSpec]] = None):
        self._by_hash: Dict[str, List[ModelSpec]] = {}
        self._builders: Dict[str, Callable] = {}
        for s in specs or _load_specs():
            self._by_hash.setdefault(s.model_hash, []).append(s)

    def register_builder(self, model_name: str, fn: Callable):
        """fn(state_dict, extra_kwargs, dtype, device) -> (params, config)."""
        self._builders[model_name] = fn

    def builder(self, model_name: str) -> Callable:
        """The builder of ``model_name``; a name the port has no builder for
        raises ``NotImplementedError``."""
        if model_name not in self._builders:
            if model_name in _POOLLESS:
                raise NotImplementedError(
                    f"{model_name} has no model-pool builder, in the JAX package either: give "
                    f"its params to the pipeline ({_POOLLESS[model_name]})")
            raise NotImplementedError(f"{model_name} is not ported to fairygen_tpu_torch "
                                      f"(ROADMAP.md Queue 1 item 8, the image DiTs)")
        return self._builders[model_name]

    def lookup(self, model_hash: str) -> List[ModelSpec]:
        return self._by_hash.get(model_hash, [])

    def detect_file(self, path) -> List[ModelSpec]:
        return self.lookup(hash_model_file(path))

    def load(self, path, dtype=None, model_name: Optional[str] = None, device="cuda"):
        """Load, detect and build every model a file holds: a list of
        (model_name, params, config).  A detected architecture without a
        builder in the port raises, but for the pipeline-given models of
        ``_POOLLESS``, which are skipped."""
        specs = self.detect_file(path)
        if model_name is not None:
            specs = [s for s in specs if s.model_name == model_name]
        if not specs:
            return []
        # a name the JAX package's pool builds nothing for is skipped, as
        # there (a VACE checkpoint also holds its DiT, which is built)
        builders = [(s, self.builder(s.model_name)) for s in specs
                    if s.model_name not in _POOLLESS]
        state_dict = load_state_dict(path)
        out = []
        for spec, build in builders:
            params, config = build(state_dict, dict(spec.extra_kwargs), dtype, device)
            out.append((spec.model_name, params, config))
        return out


def _load_specs() -> List[ModelSpec]:
    with open(_REGISTRY_JSON) as f:
        raw = json.load(f)
    return [ModelSpec(model_hash=e["model_hash"], model_name=e["model_name"],
                      extra_kwargs=e.get("extra_kwargs", {}),
                      source_converter=e.get("state_dict_converter")) for e in raw]


MODEL_REGISTRY = ModelRegistry()
