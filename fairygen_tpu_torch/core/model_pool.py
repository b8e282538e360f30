"""ModelPool: "throw checkpoint files at me" loading (port of
fairygen_tpu/core/model_pool.py).

Each file's ``key:shape`` hash is looked up in the registry and the
recognized models are built on ``device`` by the port's converters.  The
port builds the Wan roles (the DiTs, with the I2V image branch and the
Fun-Reference conv; the S2V and LongCat-Video DiTs; wav2vec; the VAE38 and
the Wan2.1 VAE; UMT5) and the FLUX.1 and Z-Image families whose
converters it has; a registry name without a builder raises
``NotImplementedError`` naming its ROADMAP item.  A file whose hash the
registry does not know is reported and left out, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import torch

from .io import load_state_dict
from .model_config import resolve_model_paths
from .registry import MODEL_REGISTRY, ModelRegistry


def _dataclass_kwargs(cls, extra_kwargs):
    fields = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in extra_kwargs.items() if k in fields}


def _build_wan_dit(state_dict, extra_kwargs, dtype, device):
    """A Wan DiT, or the S2V or LongCat-Video DiT (their hashes map to
    wan_video_dit too; told apart by the audio kwargs and by LongCat's final
    layer).  LongCat takes its published config, or fields given by hints
    for a resized checkpoint."""
    from ..models.wan.dit import WanDiTConfig, convert_dit_state_dict

    if "final_layer.adaLN_modulation.1.weight" in state_dict:
        from ..models.wan.longcat import LongCatDiTConfig, convert_longcat_dit_state_dict

        kwargs = _dataclass_kwargs(LongCatDiTConfig, extra_kwargs)
        if "patch_size" in kwargs:
            kwargs["patch_size"] = tuple(kwargs["patch_size"])
        cfg = LongCatDiTConfig(**kwargs)
        return convert_longcat_dit_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg
    if "audio_dim" in extra_kwargs or "cond_dim" in extra_kwargs:
        from ..models.wan.s2v import S2VConfig, convert_s2v_state_dict

        kwargs = _dataclass_kwargs(S2VConfig, extra_kwargs)
        for tup in ("patch_size", "audio_inject_layers", "zip_frame_buckets"):
            if tup in kwargs:
                kwargs[tup] = tuple(kwargs[tup])
        cfg = S2VConfig(**kwargs)
        return convert_s2v_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg
    kwargs = _dataclass_kwargs(WanDiTConfig, extra_kwargs)
    # upstream options without a DiT field here (the camera DiTs'
    # add_control_adapter) are refused when set, as the JAX package's pool
    # refuses them: their adapter is set on the pipeline (camera_params)
    unknown = {k: v for k, v in extra_kwargs.items() if k not in kwargs and v}
    if unknown:
        raise NotImplementedError(f"unsupported WanModel kwargs: {sorted(unknown)} (the "
                                  "camera adapter is given to the pipeline as camera_params)")
    if "patch_size" in kwargs:
        kwargs["patch_size"] = tuple(kwargs["patch_size"])
    cfg = WanDiTConfig(**kwargs)
    return convert_dit_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_wans2v_audio_encoder(state_dict, extra_kwargs, dtype, device):
    """The S2V audio encoder: wav2vec XLSR-53 large, always fp32 (the JAX
    package's builder does the same); ``extra_kwargs`` (through hints)
    resize it."""
    from ..models.wan.wav2vec import Wav2Vec2Config, convert_wav2vec2_state_dict

    kwargs = _dataclass_kwargs(Wav2Vec2Config, extra_kwargs)
    for tup in ("conv_dim", "conv_kernel", "conv_stride"):
        if tup in kwargs:
            kwargs[tup] = tuple(kwargs[tup])
    cfg = Wav2Vec2Config(**kwargs)
    return convert_wav2vec2_state_dict(state_dict, cfg, device=device), cfg


def _build_wan_vae(state_dict, extra_kwargs, dtype, device):
    from ..models.wan.vae import (WanVAEConfig, convert_vae38_state_dict,
                                  convert_vae_v1_state_dict)

    kwargs = _dataclass_kwargs(WanVAEConfig, extra_kwargs)
    for tup in ("dim_mult", "temperal_downsample"):
        if tup in kwargs:
            kwargs[tup] = tuple(kwargs[tup])
    if kwargs:  # resized or test checkpoints, through hints (arch "38" or "v1")
        cfg = WanVAEConfig(**kwargs)
    else:  # the published VAEs, told apart by their latent width
        probe = "model.conv2.weight" if "model.conv2.weight" in state_dict else "conv2.weight"
        cfg = (WanVAEConfig.wan22_38() if state_dict[probe].shape[0] == 48
               else WanVAEConfig.wan21_16())
    convert = convert_vae38_state_dict if cfg.arch == "38" else convert_vae_v1_state_dict
    return convert(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_umt5(state_dict, extra_kwargs, dtype, device):
    from ..models.wan.text_encoder import UMT5Config, convert_umt5_state_dict

    kwargs = _dataclass_kwargs(UMT5Config, extra_kwargs)
    cfg = UMT5Config(**kwargs) if kwargs else UMT5Config.umt5_xxl()
    return convert_umt5_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_flux_dit(state_dict, extra_kwargs, dtype, device):
    from ..models.flux.dit import (FluxDiTConfig, convert_flux_dit_state_dict,
                                   normalize_flux_dit_source)

    state_dict = normalize_flux_dit_source(state_dict)
    kwargs = {}
    if "input_dim" in extra_kwargs:
        kwargs["in_dim"] = extra_kwargs["input_dim"]
    if "num_blocks" in extra_kwargs:
        kwargs["num_double_blocks"] = extra_kwargs["num_blocks"]
    kwargs["guidance_embed"] = "guidance_embedder.timestep_embedder.0.weight" in state_dict
    cfg = FluxDiTConfig(**kwargs)
    return convert_flux_dit_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_flux_clip(state_dict, extra_kwargs, dtype, device):
    from ..models.flux.text_encoders import convert_flux_clip_state_dict
    from ..models.sdxl.clip import CLIPTextConfig, convert_clip_text_state_dict

    cfg = CLIPTextConfig()  # CLIP-L
    convert = (convert_flux_clip_state_dict if "encoders.0.attn.to_q.weight" in state_dict
               else convert_clip_text_state_dict)
    return convert(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_flux_t5(state_dict, extra_kwargs, dtype, device):
    from ..models.wan.text_encoder import UMT5Config, convert_t5_encoder_state_dict

    cfg = UMT5Config.t5_v1_1_xxl()
    return convert_t5_encoder_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_flux_vae(state_dict, extra_kwargs, dtype, device):
    from ..models.flux.vae import convert_flux_vae_bfl_state_dict, convert_flux_vae_state_dict
    from ..models.sdxl.vae import AutoencoderKLConfig

    cfg = AutoencoderKLConfig.flux()
    convert = (convert_flux_vae_bfl_state_dict
               if "encoder.down.0.block.0.norm1.weight" in state_dict
               else convert_flux_vae_state_dict)
    return convert(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_z_image_dit(state_dict, extra_kwargs, dtype, device):
    from ..models.z_image.dit import ZImageDiTConfig, convert_z_image_dit_state_dict

    cfg = ZImageDiTConfig()
    return convert_z_image_dit_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def _build_z_image_te(state_dict, extra_kwargs, dtype, device):
    from ..models.qwen.text_encoder import QwenVLTextConfig, convert_qwen_vl_text_state_dict

    cfg = QwenVLTextConfig.qwen3_4b()
    return convert_qwen_vl_text_state_dict(state_dict, cfg, dtype=dtype, device=device), cfg


def install_default_builders(registry: ModelRegistry = MODEL_REGISTRY):
    registry.register_builder("wan_video_dit", _build_wan_dit)
    registry.register_builder("wan_video_vae", _build_wan_vae)
    registry.register_builder("wan_video_text_encoder", _build_umt5)
    registry.register_builder("wans2v_audio_encoder", _build_wans2v_audio_encoder)
    registry.register_builder("flux_dit", _build_flux_dit)
    registry.register_builder("flux_text_encoder_clip", _build_flux_clip)
    registry.register_builder("flux_text_encoder_t5", _build_flux_t5)
    registry.register_builder("flux_vae_encoder", _build_flux_vae)
    registry.register_builder("flux_vae_decoder", _build_flux_vae)
    registry.register_builder("z_image_dit", _build_z_image_dit)
    registry.register_builder("z_image_text_encoder", _build_z_image_te)
    return registry


class ModelPool:
    def __init__(self, registry: Optional[ModelRegistry] = None):
        self.registry = install_default_builders(registry or MODEL_REGISTRY)
        self.models: Dict[str, List[Any]] = {}

    def load(self, paths, dtype=torch.bfloat16, hints: Optional[Dict[str, Any]] = None,
             device="cuda"):
        """Build every recognized model of ``paths`` (path strings or
        ``ModelConfig`` records, resolved first) on ``device``.

        ``hints``: path -> (model_name, extra_kwargs) for checkpoints whose
        hash the registry does not know (resized or test models).  The
        environment variable ``FAIRYGEN_MODEL_HINTS`` may name a JSON file
        of ``{path: [model_name, extra_kwargs]}``, merged beneath ``hints``.
        """
        from ..device import resolve_device

        device = resolve_device(device)
        hints = dict(hints or {})
        env_hints = os.environ.get("FAIRYGEN_MODEL_HINTS")
        if env_hints:
            with open(env_hints) as f:
                for p, (name, extra) in json.load(f).items():
                    hints.setdefault(os.path.abspath(p), (name, extra))
                    hints.setdefault(p, (name, extra))
        for path in resolve_model_paths(list(paths)):
            if path in hints:
                name, extra = hints[path]
                build = self.registry.builder(name)
                params, cfg = build(load_state_dict(path), dict(extra), dtype, device)
                self.models.setdefault(name, []).append((params, cfg))
                continue
            if not self.registry.detect_file(path):
                print(f"[ModelPool] unrecognized checkpoint: {path}")
                continue
            for name, params, cfg in self.registry.load(path, dtype=dtype, device=device):
                self.models.setdefault(name, []).append((params, cfg))
                print(f"[ModelPool] loaded {name} from {path}")
        return self

    def fetch_model(self, name: str, index=None):
        """None if absent; the single entry, the first ``index`` entries as
        a list when there are more, or every entry with ``index="all"``."""
        entries = self.models.get(name, [])
        if not entries:
            return None
        if index == "all":
            return entries
        if index is None or len(entries) == 1:
            return entries[0]
        return entries[:index]
