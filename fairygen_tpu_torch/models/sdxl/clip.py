"""CLIP text towers (port of the text part of fairygen_tpu/models/sdxl/clip.py):
CLIP-L and SDXL's OpenCLIP bigG, and SDXL's dual-encoder prompt embedding.

transformers' ``CLIPTextModel``: token + learned position embeddings, a
pre-LN causal transformer, final LN, EOS pooling (argmax of the ids when
``eos_token_id`` is 2, else the first EOS), optional text projection.
Params are a nested dict of tensors; dense weights are (d_in, d_out).  The
causal attention is plain PyTorch, as it is plain XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.params import linear, to_tensors


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # CLIP-L; bigG uses "gelu"
    projection_dim: Optional[int] = None
    eos_token_id: int = 49407

    @staticmethod
    def sdxl_te1() -> "CLIPTextConfig":
        """SDXL's first text encoder, CLIP-L/14."""
        return CLIPTextConfig()

    @staticmethod
    def sdxl_te2() -> "CLIPTextConfig":
        """SDXL's second text encoder, OpenCLIP bigG/14 with its projection."""
        return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                              num_heads=20, hidden_act="gelu", projection_dim=1280)

    @staticmethod
    def tiny(**over) -> "CLIPTextConfig":
        base = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
                    num_layers=2, num_heads=4, max_position_embeddings=16)
        base.update(over)
        return CLIPTextConfig(**base)


def _act(x, kind):
    xf = x.float()
    y = xf * torch.sigmoid(1.702 * xf) if kind == "quick_gelu" else torch.nn.functional.gelu(xf)
    return y.to(x.dtype)


def _ln(p, x, eps=1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def _dense(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _attn(p, x, num_heads, causal):
    b, l, c = x.shape
    hd = c // num_heads
    q = _dense(p["q_proj"], x).reshape(b, l, num_heads, hd)
    k = _dense(p["k_proj"], x).reshape(b, l, num_heads, hd)
    v = _dense(p["v_proj"], x).reshape(b, l, num_heads, hd)
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() * (hd ** -0.5)
    logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, -1).to(x.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, l, c)
    return _dense(p["out_proj"], o)


def clip_text_encode(params, cfg: CLIPTextConfig, ids):
    """ids (B, L) -> dict(hidden_states=[per-layer input, ..., last],
    last_hidden_state, pooled[, text_embeds]); hidden_states[-2] is the
    penultimate state."""
    b, l = ids.shape
    x = params["token_embedding"][ids] + params["position_embedding"][:l]
    causal = torch.ones((l, l), dtype=torch.bool, device=ids.device).tril()
    hidden_states = [x]
    for blk in params["layers"]:
        x = x + _attn(blk["attn"], _ln(blk["ln1"], x), cfg.num_heads, causal)
        h = _dense(blk["fc1"], _ln(blk["ln2"], x))
        x = x + _dense(blk["fc2"], _act(h, cfg.hidden_act))
        hidden_states.append(x)
    last = _ln(params["final_layer_norm"], x)
    if cfg.eos_token_id == 2:
        eos = ids.argmax(-1)
    else:
        eos = (ids == cfg.eos_token_id).int().argmax(-1)
    pooled = last[torch.arange(b, device=ids.device), eos]
    out = {"hidden_states": hidden_states, "last_hidden_state": last, "pooled": pooled}
    if "text_projection" in params:
        out["text_embeds"] = pooled @ params["text_projection"].to(pooled.dtype)
    return out


def sdxl_encode_prompt(te1, te1_cfg, te2, te2_cfg, ids1, ids2):
    """SDXL's dual-encoder prompt embedding: the two penultimate hidden
    states concatenated (768 + 1280 = 2048 wide), and the second encoder's
    projected pooled output.  Returns (prompt_embeds, pooled_embeds)."""
    o1 = clip_text_encode(te1, te1_cfg, ids1)
    o2 = clip_text_encode(te2, te2_cfg, ids2)
    return torch.cat([o1["hidden_states"][-2], o2["hidden_states"][-2]], -1), o2["text_embeds"]


def clip_layer(sd, lp, names):
    """One encoder layer; ``names`` gives the checkpoint's q/k/v/out, fc1,
    fc2 names under ``lp``."""
    def norm(name):
        return {"w": np.asarray(sd[name + ".weight"]), "b": np.asarray(sd[name + ".bias"])}

    q, k, v, o, fc1, fc2 = names
    return {"ln1": norm(lp + ".layer_norm1"),
            "attn": {"q_proj": linear(sd, f"{lp}.{q}"), "k_proj": linear(sd, f"{lp}.{k}"),
                     "v_proj": linear(sd, f"{lp}.{v}"), "out_proj": linear(sd, f"{lp}.{o}")},
            "ln2": norm(lp + ".layer_norm2"),
            "fc1": linear(sd, f"{lp}.{fc1}"), "fc2": linear(sd, f"{lp}.{fc2}")}


def convert_clip_text_state_dict(sd, cfg: CLIPTextConfig, dtype=None, device="cuda"):
    """transformers CLIPTextModel state dict (numpy, ``text_model.``
    prefix optional) -> port params on ``device``."""
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
             "mlp.fc1", "mlp.fc2")
    fln = pre + "final_layer_norm"
    params = {
        "token_embedding": np.asarray(sd[pre + "embeddings.token_embedding.weight"]),
        "position_embedding": np.asarray(sd[pre + "embeddings.position_embedding.weight"]),
        "layers": [clip_layer(sd, f"{pre}encoder.layers.{i}", names)
                   for i in range(cfg.num_layers)],
        "final_layer_norm": {"w": np.asarray(sd[fln + ".weight"]),
                             "b": np.asarray(sd[fln + ".bias"])},
    }
    if "text_projection.weight" in sd:
        params["text_projection"] = np.asarray(sd["text_projection.weight"]).T
    return to_tensors(params, device, dtype)
