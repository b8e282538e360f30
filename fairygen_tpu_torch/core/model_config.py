"""ModelConfig: model-id -> local-path resolution with optional download
(port of fairygen_tpu/core/model_config.py).

A declarative "where do this model's files live" record (the upstream
loader's ``ModelConfig``): a hub ``model_id`` plus an
``origin_file_pattern`` glob resolve to local paths, downloaded from
ModelScope or HuggingFace only when the files are not already present.
Placement on a device is the builders' concern (``core.model_pool``);
this module only resolves files.  The download backends are imported
lazily, when a download is asked for: without the hub SDK the call raises
with what to do instead.

Environment overrides (upstream names in parentheses):
  FAIRYGEN_MODEL_BASE_PATH   base dir for model_id downloads
                             (DIFFSYNTH_MODEL_BASE_PATH)
  FAIRYGEN_SKIP_DOWNLOAD     "true"/"false" (DIFFSYNTH_SKIP_DOWNLOAD)
  FAIRYGEN_DOWNLOAD_SOURCE   "modelscope"|"huggingface"
                             (DIFFSYNTH_DOWNLOAD_SOURCE)
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Callable, Dict, List, Optional, Union


def _env(name: str) -> Optional[str]:
    return os.environ.get(name)


# download backends ---------------------------------------------------------
# fn(model_id, local_dir, allow_pattern, ignore_existing: list[str]) -> None
def _modelscope_download(model_id, local_dir, allow_pattern, ignore_existing):
    from modelscope import snapshot_download  # noqa: deferred heavy import

    snapshot_download(
        model_id,
        local_dir=local_dir,
        allow_file_pattern=allow_pattern,
        ignore_file_pattern=ignore_existing,
        local_files_only=False,
    )


def _huggingface_download(model_id, local_dir, allow_pattern, ignore_existing):
    from huggingface_hub import snapshot_download  # noqa: deferred heavy import

    snapshot_download(
        model_id,
        local_dir=local_dir,
        allow_patterns=allow_pattern,
        ignore_patterns=ignore_existing,
        local_files_only=False,
    )


_DOWNLOAD_BACKENDS: Dict[str, Callable] = {"modelscope": _modelscope_download,
                                           "huggingface": _huggingface_download}


@dataclasses.dataclass
class ModelConfig:
    """Declarative pointer to a model's files (local path or hub id).

    Exactly one of ``path`` / ``model_id`` is required.  ``resolve()``
    fills ``path`` and returns it.
    """

    path: Union[str, List[str], None] = None
    model_id: Optional[str] = None
    origin_file_pattern: Union[str, List[str], None] = None
    download_source: Optional[str] = None  # "modelscope" | "huggingface"
    local_model_path: Optional[str] = None
    skip_download: Optional[bool] = None

    # -- parsing (mirrors config.py:27-58 semantics) -----------------------
    def check_input(self) -> None:
        if self.path is None and self.model_id is None:
            raise ValueError(
                "No valid model files. Use ModelConfig(path=...) or "
                "ModelConfig(model_id='org/name', origin_file_pattern=...). "
                "skip_download only applies to the model_id form."
            )

    def parse_origin_file_pattern(self) -> str:
        p = self.origin_file_pattern
        if p is None or p == "":
            return "*"
        if isinstance(p, list):
            # multi-pattern: resolved per-pattern in resolve()
            return p  # type: ignore[return-value]
        if p.endswith("/"):
            return p + "*"
        return p

    def parse_download_source(self) -> str:
        if self.download_source is not None:
            return self.download_source
        return _env("FAIRYGEN_DOWNLOAD_SOURCE") or "modelscope"

    def parse_skip_download(self) -> bool:
        if self.skip_download is not None:
            return self.skip_download
        env = _env("FAIRYGEN_SKIP_DOWNLOAD")
        if env is not None:
            return env.lower() == "true"
        return False

    def parse_local_model_path(self) -> str:
        return (
            _env("FAIRYGEN_MODEL_BASE_PATH")
            or self.local_model_path
            or "./models"
        )

    # -- resolution (config.py:60-118) --------------------------------------
    def _model_dir(self) -> str:
        return os.path.join(self.parse_local_model_path(), self.model_id)

    def _existing_files(self, pattern) -> List[str]:
        patterns = pattern if isinstance(pattern, list) else [pattern]
        out: List[str] = []
        for p in patterns:
            out.extend(_glob.glob(p, root_dir=self._model_dir()))
        return sorted(set(out))

    def require_downloading(self) -> bool:
        if self.path is not None:
            return False
        return not self.parse_skip_download()

    def download(self) -> None:
        pattern = self.parse_origin_file_pattern()
        existing = self._existing_files(pattern)
        source = self.parse_download_source().lower()
        backend = _DOWNLOAD_BACKENDS.get(source)
        if backend is None:
            raise ValueError(
                f"download_source must be one of "
                f"{sorted(_DOWNLOAD_BACKENDS)}, got {source!r}"
            )
        try:
            backend(self.model_id, self._model_dir(), pattern, existing)
        except ImportError as e:
            raise RuntimeError(
                f"Downloading {self.model_id!r} requires the {source!r} "
                f"SDK, which is not installed. "
                f"Either pre-populate {self._model_dir()!r} and set "
                f"FAIRYGEN_SKIP_DOWNLOAD=true, or pass "
                f"ModelConfig(path=...) directly."
            ) from e

    def resolve(self) -> Union[str, List[str]]:
        """Resolve to local path(s), downloading only if needed.

        Reference: ``download_if_necessary`` (config.py:98-109) —
        including the single-element-list flattening quirk (config.py:108).
        """
        self.check_input()
        if self.path is None:
            if self.require_downloading():
                self.download()
            pattern = self.parse_origin_file_pattern()
            if self.origin_file_pattern is None or self.origin_file_pattern == "":
                self.path = self._model_dir()
            else:
                patterns = pattern if isinstance(pattern, list) else [pattern]
                found: List[str] = []
                for p in patterns:
                    found.extend(
                        sorted(_glob.glob(os.path.join(self._model_dir(), p)))
                    )
                if not found:
                    raise FileNotFoundError(
                        f"no files matching {patterns} under "
                        f"{self._model_dir()!r} (skip_download="
                        f"{self.parse_skip_download()})"
                    )
                self.path = found
        if isinstance(self.path, list) and len(self.path) == 1:
            self.path = self.path[0]
        return self.path

    # kept for API familiarity with the reference
    download_if_necessary = resolve


def resolve_model_paths(
    items: List[Union[str, ModelConfig]],
) -> List[str]:
    """Flatten a mixed list of paths / ModelConfigs into concrete paths."""
    out: List[str] = []
    for item in items:
        if isinstance(item, ModelConfig):
            resolved = item.resolve()
        else:
            resolved = item
        if isinstance(resolved, list):
            out.extend(resolved)
        else:
            out.append(resolved)
    return out


def override_config(name: str, cfg):
    """Apply ``FAIRYGEN_CONFIG_OVERRIDES`` to a hardcoded CLI model config.

    The env var names a JSON file ``{name: {field: value}}``; when ``name``
    has an entry, the matching dataclass fields of ``cfg`` are replaced
    (lists coerce to tuples where the current value is a tuple).  This is
    the config-side sibling of ``FAIRYGEN_MODEL_HINTS`` (model_pool.py):
    CLIs whose architectures are fixed at full size (e.g. ``dora_train.py``
    pinning ``UNet2DConfig.sdxl_base()``) stay zero-flag for production
    checkpoints while resized/tiny CI checkpoints remain loadable — the
    reference gets this for free from per-checkpoint config.json files,
    which the hash-registry design intentionally does not carry.
    """
    import dataclasses
    import json
    import os

    path = os.environ.get("FAIRYGEN_CONFIG_OVERRIDES")
    if not path:
        return cfg
    with open(path) as f:
        table = json.load(f)
    fields = table.get(name)
    if not fields:
        return cfg
    coerced = {}
    for k, v in fields.items():
        cur = getattr(cfg, k)  # raises on unknown field names: typo guard
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        coerced[k] = v
    return dataclasses.replace(cfg, **coerced)
