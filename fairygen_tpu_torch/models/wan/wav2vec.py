"""Wav2Vec2 audio feature extractor, XLSR-53 large by default (port of
fairygen_tpu/models/wan/wav2vec.py).

Upstream's ``WanS2VAudioEncoder`` runs transformers' ``Wav2Vec2ForCTC``
(facebook/wav2vec2-large-xlsr-53) as a feature extractor: all 25 hidden
states of the raw 16 kHz waveform, resampled from 50 to 30 frames a
second.  The tower here is transformers' ``Wav2Vec2Model`` with
``do_stable_layer_norm`` written out, without transformers:

  * 7 convs over the waveform (kernels 10/3/3/3/3/2/2, strides
    5/2/2/2/2/2/2: one frame per 320 samples), each followed by a channel
    LayerNorm and the exact GELU;
  * the feature projection (LayerNorm, Linear 512 -> 1024);
  * the grouped conv position embedding (kernel 128, 16 groups, same pad,
    the trailing frame dropped for the even kernel) + GELU, added;
  * 24 pre-norm layers (LN -> biased MHA with an fp32 softmax; LN -> GELU
    MLP), then a final LayerNorm.

State 0 is the position-embedded projection, states 1..23 the inputs of
layers 1..23, state 24 the last layer's output after the final LayerNorm,
as transformers counts them.  Everything runs in fp32, and the attention
is plain PyTorch (the JAX package's is XLA's too: no kernel goes here).
Conv weights keep the JAX package's (k, in, out) layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors
from ...ops.norms import layer_norm
from .s2v import get_audio_embed_bucket_fps, linear_interpolation_np


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """facebook/wav2vec2-large-xlsr-53."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _conv1d_nwc(x, w, b=None, stride=1, padding=0, groups=1):
    """x (B, T, C_in), w (k, C_in / groups, C_out) -> (B, T', C_out)."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype), stride=stride,
                 padding=padding, groups=groups).transpose(1, 2)
    return y if b is None else y + b.to(x.dtype)


def _attention(p, x, num_heads: int):
    """Biased MHA with an fp32 softmax (transformers' Wav2Vec2Attention)."""
    b, t, c = x.shape
    d = c // num_heads

    def split(h):
        return h.reshape(b, t, num_heads, d)

    q = split(_dense(p["q"], x)) * (d ** -0.5)
    k = split(_dense(p["k"], x))
    v = split(_dense(p["v"], x))
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, t, c)
    return _dense(p["o"], o)


def wav2vec2_all_hidden_states(params, cfg: Wav2Vec2Config, input_values):
    """input_values (B, T) normalized waveform -> (L+1, B, T', hidden)."""
    x = input_values.float()[..., None]  # (B, T, 1)
    for conv, stride in zip(params["conv_layers"], cfg.conv_stride):
        x = _conv1d_nwc(x, conv["conv"]["w"], conv["conv"].get("b"), stride=stride)
        x = F.gelu(layer_norm(x, cfg.layer_norm_eps, conv["ln"]["w"], conv["ln"]["b"]))
    x = layer_norm(x, cfg.layer_norm_eps, params["fp_ln"]["w"], params["fp_ln"]["b"])
    x = _dense(params["fp_proj"], x)
    k = cfg.num_conv_pos_embeddings
    pos = _conv1d_nwc(x, params["pos_conv"]["w"], params["pos_conv"]["b"], padding=k // 2,
                      groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos)
    states = []
    for layer in params["layers"]:
        states.append(x)
        y = layer_norm(x, cfg.layer_norm_eps, layer["ln1"]["w"], layer["ln1"]["b"])
        x = x + _attention(layer, y, cfg.num_attention_heads)
        y = layer_norm(x, cfg.layer_norm_eps, layer["ln2"]["w"], layer["ln2"]["b"])
        x = x + _dense(layer["ffn2"], F.gelu(_dense(layer["ffn1"], y)))
    states.append(layer_norm(x, cfg.layer_norm_eps, params["final_ln"]["w"],
                             params["final_ln"]["b"]))
    return torch.stack(states)


def normalize_waveform(waveform: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor's zero-mean / unit-variance normalization."""
    x = np.asarray(waveform, np.float32).reshape(-1)
    return (x - x.mean()) / np.sqrt(x.var() + 1e-7)


def resample_waveform(waveform: np.ndarray, sample_rate: int,
                      target_rate: int = 16000) -> np.ndarray:
    """Linear resample to ``target_rate`` (the identity at that rate)."""
    if sample_rate == target_rate:
        return np.asarray(waveform, np.float32).reshape(-1)
    x = np.asarray(waveform, np.float32).reshape(-1)
    n_out = int(round(len(x) * target_rate / sample_rate))
    t_in = np.arange(len(x)) / sample_rate
    t_out = np.arange(n_out) / target_rate
    return np.interp(t_out, t_in, x).astype(np.float32)


@torch.no_grad()
def extract_audio_feat(params, cfg: Wav2Vec2Config, waveform, sample_rate: int = 16000,
                       video_rate: int = 30) -> np.ndarray:
    """waveform (T,) -> (L+1, frames at ``video_rate``, hidden) fp32 numpy;
    the tower runs on the device its params live on."""
    x = normalize_waveform(resample_waveform(waveform, sample_rate))
    dev = params["fp_proj"]["w"].device
    states = wav2vec2_all_hidden_states(params, cfg, torch.from_numpy(x)[None].to(dev))
    feat = states[:, 0].float().cpu().numpy()
    return linear_interpolation_np(feat, input_fps=50, output_fps=video_rate)


def audio_embeds_from_waveform(params, cfg: Wav2Vec2Config, waveform, sample_rate: int = 16000,
                               num_frames: int = 81, fps: int = 16, m: int = 0,
                               video_rate: int = 30) -> List[np.ndarray]:
    """The S2V audio buckets of a waveform: a list of (1, L+1, hidden·(2m+1),
    num_frames - 1) fp32 arrays, one per clip of ``num_frames`` frames."""
    batch_frames = num_frames - 1
    feat = extract_audio_feat(params, cfg, waveform, sample_rate, video_rate)
    bucket, n = get_audio_embed_bucket_fps(feat, fps=fps, batch_frames=batch_frames, m=m,
                                           video_rate=video_rate)
    emb = bucket[None].transpose(0, 2, 3, 1).astype(np.float32)
    return [emb[..., i * batch_frames:(i + 1) * batch_frames] for i in range(n)]


# --------------------------------------------------------------- converter
def _resolve_weight_norm(sd, prefix: str) -> np.ndarray:
    """A weight_norm(dim=2) conv weight from the legacy ``weight_g`` /
    ``weight_v`` or the parametrize ``original0`` / ``original1`` keys."""
    if prefix + ".weight" in sd:
        return np.asarray(sd[prefix + ".weight"])
    if prefix + ".weight_g" in sd:
        g = np.asarray(sd[prefix + ".weight_g"])
        v = np.asarray(sd[prefix + ".weight_v"])
    else:
        g = np.asarray(sd[prefix + ".parametrizations.weight.original0"])
        v = np.asarray(sd[prefix + ".parametrizations.weight.original1"])
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    return (g * v / norm).astype(v.dtype)


def convert_wav2vec2_state_dict(sd: Dict[str, np.ndarray], cfg: Optional[Wav2Vec2Config] = None,
                                device="cuda") -> Dict[str, Any]:
    """transformers ``Wav2Vec2ForCTC`` / ``Wav2Vec2Model`` state dict (with
    an optional ``model.`` / ``wav2vec2.`` prefix) -> fp32 port params on
    ``device``."""
    cfg = cfg or Wav2Vec2Config()
    for pre in ("model.", "wav2vec2."):
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}

    def g(name):
        return np.asarray(sd[name]).astype(np.float32)

    def lw(name):
        return {"w": g(name + ".weight").T, "b": g(name + ".bias")}

    def ln(name):
        return {"w": g(name + ".weight"), "b": g(name + ".bias")}

    conv_layers = []
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        p = {"conv": {"w": g(pre + ".conv.weight").transpose(2, 1, 0)},
             "ln": ln(pre + ".layer_norm")}
        if cfg.conv_bias:
            p["conv"]["b"] = g(pre + ".conv.bias")
        conv_layers.append(p)
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        layers.append({
            "ln1": ln(pre + ".layer_norm"),
            "q": lw(pre + ".attention.q_proj"), "k": lw(pre + ".attention.k_proj"),
            "v": lw(pre + ".attention.v_proj"), "o": lw(pre + ".attention.out_proj"),
            "ln2": ln(pre + ".final_layer_norm"),
            "ffn1": lw(pre + ".feed_forward.intermediate_dense"),
            "ffn2": lw(pre + ".feed_forward.output_dense"),
        })
    pos_w = _resolve_weight_norm(sd, "encoder.pos_conv_embed.conv")
    params = {
        "conv_layers": conv_layers,
        "fp_ln": ln("feature_projection.layer_norm"),
        "fp_proj": lw("feature_projection.projection"),
        "pos_conv": {"w": pos_w.astype(np.float32).transpose(2, 1, 0),
                     "b": g("encoder.pos_conv_embed.conv.bias")},
        "layers": layers,
        "final_ln": ln("encoder.layer_norm"),
    }
    return to_tensors(params, device)
