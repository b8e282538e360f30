"""Qwen3 text encoder, the text path (port of the text path of
fairygen_tpu/models/qwen/text_encoder.py).

Z-Image conditions on the penultimate hidden state of Qwen3-4B run over its
prompt.  The decoder stack: GQA attention (kv heads repeated; q/k/v biases
when ``attn_bias``), per-head q/k RMS norms before RoPE (Qwen3,
``qk_norm``), rotate-half RoPE from fp64 host tables, causal + padding
mask, fp32 softmax rounded to x.dtype; RMSNorm pre-norms, SwiGLU MLP with
the gate's SiLU in fp32; a final RMSNorm.  ``head_dim_override`` decouples
the head width from dim / heads, so ``o`` consumes heads x head_dim.  The
attention is a plain product, as it is plain XLA in the JAX package.

Params are a nested dict of tensors, ``layers`` a list of dicts; dense
weights are (d_in, d_out).  The multimodal inputs of Qwen-Image (vision
embeds spliced into the prompt, mRoPE positions, input embeddings) are not
ported and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import Init, generator, linear, to_tensors
from ...device import resolve_device
from ...ops.norms import rms_norm

_QWEN_IMAGE_ITEM = ("the Qwen-Image path (mRoPE, the vision tower; ROADMAP Queue 1 item 8) "
                    "is not ported yet")


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    vocab: int = 152064
    dim: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    ffn_dim: int = 18944
    rope_theta: float = 1000000.0
    eps: float = 1e-6
    head_dim_override: int = 0  # Qwen3 decouples head_dim from dim/heads
    qk_norm: bool = False  # Qwen3 per-head q/k RMS norms
    attn_bias: bool = True  # Qwen2.5 has q/k/v biases; Qwen3 none

    @property
    def head_dim(self):
        return self.head_dim_override or self.dim // self.num_heads

    @staticmethod
    def qwen3_4b() -> "QwenVLTextConfig":
        """Z-Image's text encoder: 36 layers, dim 2560, 32 q / 8 kv heads of
        128, SwiGLU 9728, q/k norms, no biases."""
        return QwenVLTextConfig(
            vocab=151936, dim=2560, num_layers=36, num_heads=32,
            num_kv_heads=8, ffn_dim=9728, head_dim_override=128,
            qk_norm=True, attn_bias=False)

    @staticmethod
    def tiny(**over) -> "QwenVLTextConfig":
        base = dict(vocab=128, dim=32, num_layers=2, num_heads=4,
                    num_kv_heads=2, ffn_dim=48)
        base.update(over)
        return QwenVLTextConfig(**base)


def _dense(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def _rope_cos_sin(length: int, head_dim: int, theta: float, device):
    """(L, head_dim) fp32 cos/sin, rotate-half convention (each frequency
    on both halves); angles in fp64 on the host."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    ang = np.einsum("l,d->ld", np.arange(length, dtype=np.float64), inv)
    ang = np.concatenate([ang, ang], axis=-1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _apply_rope_half(x, cos, sin):
    """(B, L, N, D) rotate-half RoPE in fp32, cast back."""
    d = x.shape[-1]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos[None, :, None, :] + rot * sin[None, :, None, :]).to(x.dtype)


def qwen_vl_text_encode(params, cfg: QwenVLTextConfig, ids,
                        attention_mask: Optional[torch.Tensor] = None,
                        hidden_state_index: Optional[int] = None,
                        hidden_state_indices=None, image_embeds=None, position_ids=None,
                        inputs_embeds=None):
    """ids (B, L) -> hidden states (B, L, dim).

    ``hidden_state_index``: None -> the post-final-norm last hidden state;
    -2 -> the input of the last layer (run num_layers-1 layers, no final
    norm: what Z-Image consumes).  ``hidden_state_indices``: positive layer
    indices -> the list of those layers' raw outputs.  ``attention_mask``
    (B, L): 0 marks padding keys."""
    if image_embeds is not None or position_ids is not None or inputs_embeds is not None:
        raise NotImplementedError(_QWEN_IMAGE_ITEM)
    b, l = ids.shape
    n, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][ids]
    dev = x.device
    cos, sin = _rope_cos_sin(l, hd, cfg.rope_theta, dev)
    allowed = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))[None, None]
    if attention_mask is not None:
        allowed = allowed & (torch.as_tensor(attention_mask, device=dev)[:, None, None, :] > 0)
    neg = torch.tensor(torch.finfo(torch.float32).min, device=dev)

    layers = params["layers"]
    if hidden_state_index is not None:
        if hidden_state_index >= 0:
            raise ValueError(f"hidden_state_index must be negative, got {hidden_state_index}")
        layers = layers[: len(layers) + 1 + hidden_state_index]
    if hidden_state_indices:
        # layers past the deepest requested hidden state are dead compute
        layers = layers[: max(hidden_state_indices)]
    collected = {}
    for li, p in enumerate(layers):
        h = rms_norm(x, p["ln1"], cfg.eps)
        q = _dense(p["q"], h).reshape(b, l, n, hd)
        k = _dense(p["k"], h).reshape(b, l, nk, hd)
        v = _dense(p["v"], h).reshape(b, l, nk, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.eps)
            k = rms_norm(k, p["k_norm"], cfg.eps)
        q = _apply_rope_half(q, cos, sin)
        k = _apply_rope_half(k, cos, sin)
        k = k.repeat_interleave(n // nk, dim=2)
        v = v.repeat_interleave(n // nk, dim=2)
        logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() * (hd ** -0.5)
        probs = torch.softmax(torch.where(allowed, logits, neg), -1).to(x.dtype)
        o = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, l, n * hd)
        x = x + _dense(p["o"], o)
        h = rms_norm(x, p["ln2"], cfg.eps)
        gate = F.silu(_dense(p["gate"], h).float()).to(x.dtype)
        x = x + _dense(p["down"], gate * _dense(p["up"], h))
        if hidden_state_indices and (li + 1) in hidden_state_indices:
            collected[li + 1] = x
    if hidden_state_indices:
        return [collected[i] for i in hidden_state_indices]
    if hidden_state_index is not None:
        return x
    return rms_norm(x, params["norm"], cfg.eps)


# ------------------------------------------------------------------ params
def init_qwen_text_params(cfg: QwenVLTextConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Seeded random params made on ``device``, in the converter's tree:
    N(0, 1) token embedding, dense N(0, 1/d_in) with zero biases (q/k/v
    only, when ``attn_bias``), unit norms."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, hd = cfg.dim, cfg.head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def layer():
        p = {"ln1": r.ones((d,)), "q": r.dense(d, nq, cfg.attn_bias),
             "k": r.dense(d, nkv, cfg.attn_bias), "v": r.dense(d, nkv, cfg.attn_bias),
             "o": r.dense(nq, d, False), "ln2": r.ones((d,)),
             "gate": r.dense(d, cfg.ffn_dim, False), "up": r.dense(d, cfg.ffn_dim, False),
             "down": r.dense(cfg.ffn_dim, d, False)}
        if cfg.qk_norm:
            p["q_norm"], p["k_norm"] = r.ones((hd,)), r.ones((hd,))
        return p

    return {"embed": r.normal((cfg.vocab, d), 1.0),
            "layers": [layer() for _ in range(cfg.num_layers)],
            "norm": r.ones((d,))}


# ------------------------------------------------------------------ convert
def convert_qwen_vl_text_state_dict(sd: Dict[str, np.ndarray], cfg: QwenVLTextConfig,
                                    dtype=None, device="cuda"):
    """transformers Qwen2.5-VL / Qwen3 naming (``language_model.``,
    ``model.language_model.``, ``model.`` or bare prefixes; a vision tower
    is ignored), numpy -> port params on ``device``."""
    pre = ""
    for cand in ("language_model.", "model.language_model.", "model."):
        if any(k.startswith(cand + "layers.0.") for k in sd):
            pre = cand
            break

    layers = []
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}"
        layer = {
            "ln1": np.asarray(sd[lp + ".input_layernorm.weight"]),
            "q": linear(sd, lp + ".self_attn.q_proj"),
            "k": linear(sd, lp + ".self_attn.k_proj"),
            "v": linear(sd, lp + ".self_attn.v_proj"),
            "o": linear(sd, lp + ".self_attn.o_proj"),
            "ln2": np.asarray(sd[lp + ".post_attention_layernorm.weight"]),
            "gate": linear(sd, lp + ".mlp.gate_proj"),
            "up": linear(sd, lp + ".mlp.up_proj"),
            "down": linear(sd, lp + ".mlp.down_proj"),
        }
        if cfg.qk_norm:
            layer["q_norm"] = np.asarray(sd[lp + ".self_attn.q_norm.weight"])
            layer["k_norm"] = np.asarray(sd[lp + ".self_attn.k_norm.weight"])
        layers.append(layer)
    params = {"embed": np.asarray(sd[pre + "embed_tokens.weight"]), "layers": layers,
              "norm": np.asarray(sd[pre + "norm.weight"])}
    return to_tensors(params, device, dtype)
