"""FLUX.1 text encoders (port of fairygen_tpu/models/flux/text_encoders.py).

TE1 (CLIP-L) is ``models/sdxl/clip.py``'s text tower, of which FLUX uses the
pooled output; TE2 (T5-XXL v1.1) is ``models/wan/text_encoder.py`` with
``shared_pos_bias`` (``UMT5Config.t5_v1_1_xxl()``).
"""
from __future__ import annotations

import numpy as np

from ...core.params import to_tensors
from ..sdxl.clip import CLIPTextConfig, clip_layer, clip_text_encode
from ..wan.text_encoder import UMT5Config, convert_t5_encoder_state_dict, umt5_encode

__all__ = ["CLIPTextConfig", "UMT5Config", "clip_text_encode", "convert_flux_clip_state_dict",
           "convert_t5_encoder_state_dict", "flux_clip_l_config", "flux_encode_prompt_clip",
           "umt5_encode"]


def flux_clip_l_config() -> CLIPTextConfig:
    """FLUX TE1: CLIP-L, quick GELU, first-EOS pooling."""
    return CLIPTextConfig()


def flux_encode_prompt_clip(params, cfg: CLIPTextConfig, ids):
    """-> pooled (B, hidden), the only CLIP output FLUX consumes."""
    return clip_text_encode(params, cfg, ids)["pooled"]


def convert_flux_clip_state_dict(sd, cfg: CLIPTextConfig, dtype=None, device="cuda"):
    """Upstream FluxTextEncoderClip naming (token_embedding / position_embeds
    / encoders.{i}.attn.to_* / fc1 / fc2 / final_layer_norm), numpy -> port
    params on ``device``."""
    names = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out", "fc1", "fc2")
    params = {
        "token_embedding": np.asarray(sd["token_embedding.weight"]),
        "position_embedding": np.asarray(sd["position_embeds"])[0],
        "layers": [clip_layer(sd, f"encoders.{i}", names) for i in range(cfg.num_layers)],
        "final_layer_norm": {"w": np.asarray(sd["final_layer_norm.weight"]),
                             "b": np.asarray(sd["final_layer_norm.bias"])},
    }
    return to_tensors(params, device, dtype)
