"""Z-Image DiT (port of fairygen_tpu/models/z_image/dit.py).

A single-stream stack: noise-refiner blocks over the image tokens
(modulated), context-refiner blocks over the caption tokens (Qwen3
penultimate hidden states; unmodulated), then the unified blocks over
[image; caption].  Sandwich RMS norms (K9, ``rms_modulate``), tanh-gated
four-way AdaLN from a 256-wide timestep embedding, SwiGLU FFN, per-head q/k
RMS norms and three-axis interleaved RoPE at theta 256: caption positions
take axis-0 ids 1..L, the image frame starts past them, padding keeps (0,
0, 0).  Both streams pad to a multiple of 32 with repeated last rows, then
overwritten by learned pad tokens, which attend (batch 1, no mask).

With head_dim 128 the attention takes the fused per-head entry (K7 on q
and k, then K3, or K4 for one key tile), with hd^-1/2·log2e folded into
the raw q gamma at call time; other head widths take the plain rms ->
RoPE -> bounded attention chain.  Params are a nested dict of tensors, the
unified blocks a list ``layers``; dense weights are (d_in, d_out).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core.params import Init, generator, linear, to_tensors
from ...device import resolve_device
from ...ops import quant
from ...ops.attention import attention
from ...ops.fused_norms import rms_modulate
from ...ops.fused_qk import fused_qk_attention_per_head
from ...ops.norms import rms_norm
from ...ops.rope import apply_interleaved_rope

SEQ_MULTI_OF = 32
ADALN_EMBED_DIM = 256


@dataclasses.dataclass(frozen=True)
class ZImageDiTConfig:
    dim: int = 3840
    num_heads: int = 30
    in_channels: int = 16
    patch_size: int = 2
    num_layers: int = 30
    num_refiner_layers: int = 2
    cap_feat_dim: int = 2560  # Qwen3-4B hidden
    time_freq_dim: int = 256
    time_mid_dim: int = 1024
    theta: float = 256.0
    t_scale: float = 1000.0
    axes_dims: Tuple[int, ...] = (32, 48, 48)
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def adaln_dim(self):
        return min(self.dim, ADALN_EMBED_DIM)

    @staticmethod
    def z_image() -> "ZImageDiTConfig":
        return ZImageDiTConfig()

    @staticmethod
    def tiny(**over) -> "ZImageDiTConfig":
        base = dict(dim=96, num_heads=4, in_channels=4, cap_feat_dim=48,
                    num_layers=2, num_refiner_layers=1, axes_dims=(8, 8, 8))
        base.update(over)
        return ZImageDiTConfig(**base)


def _dense(p, x):
    if "w_int8" in p:  # W8A8 (ops/quant.quantize_image_dit_params)
        return quant.quantized_dense(p, x)
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def _timestep_embed(p, t, cfg: ZImageDiTConfig):
    """[cos, sin] sinusoid in fp32, cast to the parameter dtype, then the
    SiLU MLP."""
    half = cfg.time_freq_dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], -1).to(p["fc1"]["w"].dtype)
    return _dense(p["fc2"], F.silu(_dense(p["fc1"], emb)))


def _rope_tables(ids: np.ndarray, axes_dims, theta: float):
    """(L, head_dim/2) fp32 cos/sin (numpy) from (L, 3) integer ids, angles
    in fp64."""
    cos_p, sin_p = [], []
    for i, d in enumerate(axes_dims):
        inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.einsum("n,d->nd", ids[:, i].astype(np.float64), inv)
        cos_p.append(np.cos(ang))
        sin_p.append(np.sin(ang))
    return (np.concatenate(cos_p, -1).astype(np.float32),
            np.concatenate(sin_p, -1).astype(np.float32))


def _attention(p, x, cos, sin, cfg: ZImageDiTConfig):
    b, l, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    xq, xk = _dense(p["to_q"], x), _dense(p["to_k"], x)
    v = _dense(p["to_v"], x).reshape(b, l, n, hd)
    if hd == 128:
        o = fused_qk_attention_per_head(xq, xk, v, p["norm_q"], p["norm_k"], cos, sin, n, 1e-5)
        return _dense(p["to_out"], o.reshape(b, l, n * hd))
    q = apply_interleaved_rope(rms_norm(xq.reshape(b, l, n, hd), p["norm_q"], 1e-5), cos, sin)
    k = apply_interleaved_rope(rms_norm(xk.reshape(b, l, n, hd), p["norm_k"], 1e-5), cos, sin)
    o = attention(q, k, v, bounded_logits=True).reshape(b, l, n * hd)
    return _dense(p["to_out"], o)


def z_block(p, x, cos, sin, cfg: ZImageDiTConfig, adaln=None):
    """ZImageTransformerBlock: sandwich RMS norms (K9), tanh gates, 1+scale
    modulation from ``adaln`` (the timestep embedding; None: unmodulated).
    The modulation rows stay in the embedding's dtype, as in the JAX
    package: 1 + scale and tanh round there."""
    if adaln is not None:
        sc_msa, g_msa, sc_mlp, g_mlp = _dense(p["adaln"], adaln)[:, None, :].chunk(4, dim=-1)
        sc_msa, sc_mlp = 1.0 + sc_msa, 1.0 + sc_mlp
        g_msa, g_mlp = torch.tanh(g_msa), torch.tanh(g_mlp)
    else:
        sc_msa = sc_mlp = None
    a = _attention(p["attn"], rms_modulate(x, p["norm1"], sc_msa, cfg.eps), cos, sin, cfg)
    a = rms_modulate(a, p["norm2"], None, cfg.eps)
    x = x + (a if adaln is None else g_msa * a)
    h = rms_modulate(x, p["ffn_norm1"], sc_mlp, cfg.eps)
    ff = _dense(p["ffn"]["w2"], F.silu(_dense(p["ffn"]["w1"], h)) * _dense(p["ffn"]["w3"], h))
    ff = rms_modulate(ff, p["ffn_norm2"], None, cfg.eps)
    return x + (ff if adaln is None else g_mlp * ff)


def _pad_rows(x, pad: int):
    """Pad (1, L, C) to L + pad rows by repeating the last row."""
    return torch.cat([x, x[:, -1:].expand(-1, pad, -1)], dim=1) if pad else x


def z_image_dit_forward(params, cfg: ZImageDiTConfig, latents, timestep, cap_feats,
                        remat: bool = False):
    """Batch-1 forward: latents (1, C, H, W), timestep (1,) in the model's
    domain (the pipeline passes (1000 - t)/1000), cap_feats (1, Lc,
    cap_feat_dim) unpadded.  ``remat`` recomputes each unified block in the
    backward pass (``torch.utils.checkpoint``).  Returns (1, C, H, W)."""
    b, c, H, W = latents.shape
    if b != 1:
        raise ValueError(f"the Z-Image forward runs one sample at a time, got batch {b}")
    p_sz, dtype, dev = cfg.patch_size, latents.dtype, latents.device
    ht, wt = H // p_sz, W // p_sz

    t_emb = _timestep_embed(params["t_embedder"], timestep.float() * cfg.t_scale, cfg).to(dtype)

    # caption stream: pad to /32 with the repeated last row, then the pad token
    lc = cap_feats.shape[1]
    lc_pad = (-lc) % SEQ_MULTI_OF
    cap = _pad_rows(cap_feats, lc_pad).to(dtype)
    cap = _dense(params["cap_embedder"]["fc"],
                 rms_norm(cap, params["cap_embedder"]["norm"], cfg.eps))
    if lc_pad:
        cap[:, lc:] = params["cap_pad_token"].to(dtype)
    cap_ids = np.zeros((lc + lc_pad, 3), np.int64)
    cap_ids[:, 0] = np.arange(1, lc + lc_pad + 1)
    cap_cos, cap_sin = _rope_tables(cap_ids, cfg.axes_dims, cfg.theta)

    # image stream: patchify (h w) x (ph pw c), pad to /32
    x = latents.reshape(1, c, ht, p_sz, wt, p_sz).permute(0, 2, 4, 3, 5, 1)
    x = x.reshape(1, ht * wt, p_sz * p_sz * c)
    li = ht * wt
    li_pad = (-li) % SEQ_MULTI_OF
    x = _dense(params["x_embedder"], _pad_rows(x, li_pad))
    if li_pad:
        x[:, li:] = params["x_pad_token"].to(dtype)
    img_ids = np.zeros((li + li_pad, 3), np.int64)
    grid = np.stack(np.meshgrid(np.arange(1), np.arange(ht), np.arange(wt), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    grid[:, 0] += lc + lc_pad + 1
    img_ids[:li] = grid  # padding keeps (0, 0, 0)
    img_cos, img_sin = _rope_tables(img_ids, cfg.axes_dims, cfg.theta)

    u_cos, u_sin = (torch.from_numpy(np.concatenate(t, 0)).to(dev)
                    for t in ((img_cos, cap_cos), (img_sin, cap_sin)))
    li_all = li + li_pad
    for p in params["noise_refiner"]:
        x = z_block(p, x, u_cos[:li_all], u_sin[:li_all], cfg, adaln=t_emb)
    for p in params["context_refiner"]:
        cap = z_block(p, cap, u_cos[li_all:], u_sin[li_all:], cfg, adaln=None)

    # unified = [image; caption]
    u = torch.cat([x, cap], dim=1)
    for p in params["layers"]:
        if remat:
            u = checkpoint(z_block, p, u, u_cos, u_sin, cfg, t_emb, use_reentrant=False)
        else:
            u = z_block(p, u, u_cos, u_sin, cfg, adaln=t_emb)

    # final layer: LayerNorm without affine, 1 + scale from SiLU + linear
    scale = 1.0 + _dense(params["final"]["adaln"], F.silu(t_emb))
    uf = u.float()
    mu = uf.mean(-1, keepdim=True)
    var = (uf - mu).pow(2).mean(-1, keepdim=True)
    un = ((uf - mu) * torch.rsqrt(var + 1e-6)).to(dtype)
    out = _dense(params["final"]["linear"], un * scale[:, None, :])[:, :li]
    out = out.reshape(1, ht, wt, p_sz, p_sz, c).permute(0, 5, 1, 3, 2, 4)
    return out.reshape(1, c, H, W)


# ------------------------------------------------------------------ params
def init_z_image_dit_params(cfg: ZImageDiTConfig, device="cuda", dtype=torch.bfloat16,
                            seed=0):
    """Seeded random params made on ``device``, in the tree of the JAX
    package's ``init_z_image_dit_params`` (the unified blocks a list):
    dense N(0, 1/d_in) with zero biases, unit norms, N(0, 0.02²) pad
    tokens."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, hd = cfg.dim, cfg.head_dim
    ffn_dim = int(d / 3 * 8)

    def block(modulated=True):
        p = {
            "attn": {"to_q": r.dense(d, d, False), "to_k": r.dense(d, d, False),
                     "to_v": r.dense(d, d, False), "to_out": r.dense(d, d, False),
                     "norm_q": r.ones((hd,)), "norm_k": r.ones((hd,))},
            "ffn": {"w1": r.dense(d, ffn_dim, False), "w2": r.dense(ffn_dim, d, False),
                    "w3": r.dense(d, ffn_dim, False)},
            "norm1": r.ones((d,)), "norm2": r.ones((d,)),
            "ffn_norm1": r.ones((d,)), "ffn_norm2": r.ones((d,)),
        }
        if modulated:
            p["adaln"] = r.dense(cfg.adaln_dim, 4 * d)
        return p

    in_dim = cfg.patch_size ** 2 * cfg.in_channels
    return {
        "t_embedder": {"fc1": r.dense(cfg.time_freq_dim, cfg.time_mid_dim),
                       "fc2": r.dense(cfg.time_mid_dim, cfg.adaln_dim)},
        "cap_embedder": {"norm": r.ones((cfg.cap_feat_dim,)),
                         "fc": r.dense(cfg.cap_feat_dim, d)},
        "x_embedder": r.dense(in_dim, d),
        "x_pad_token": r.normal((d,), 0.02),
        "cap_pad_token": r.normal((d,), 0.02),
        "noise_refiner": [block() for _ in range(cfg.num_refiner_layers)],
        "context_refiner": [block(False) for _ in range(cfg.num_refiner_layers)],
        "layers": [block() for _ in range(cfg.num_layers)],
        "final": {"adaln": r.dense(cfg.adaln_dim, d), "linear": r.dense(d, in_dim)},
    }


# ------------------------------------------------------------------ convert
def convert_z_image_dit_state_dict(sd: Dict[str, Any], cfg: ZImageDiTConfig, dtype=None,
                                   device="cuda"):
    """Upstream ZImageDiT module naming (numpy; patch key '2-1' of the
    all_x_embedder / all_final_layer dicts) -> port params on ``device``."""
    def vec(name):
        return np.asarray(sd[name])

    def block(pre, modulated=True):
        p = {
            "attn": {"to_q": linear(sd, pre + ".attention.to_q"),
                     "to_k": linear(sd, pre + ".attention.to_k"),
                     "to_v": linear(sd, pre + ".attention.to_v"),
                     "to_out": linear(sd, pre + ".attention.to_out.0"),
                     "norm_q": vec(pre + ".attention.norm_q.weight"),
                     "norm_k": vec(pre + ".attention.norm_k.weight")},
            "ffn": {"w1": linear(sd, pre + ".feed_forward.w1"),
                    "w2": linear(sd, pre + ".feed_forward.w2"),
                    "w3": linear(sd, pre + ".feed_forward.w3")},
            "norm1": vec(pre + ".attention_norm1.weight"),
            "norm2": vec(pre + ".attention_norm2.weight"),
            "ffn_norm1": vec(pre + ".ffn_norm1.weight"),
            "ffn_norm2": vec(pre + ".ffn_norm2.weight"),
        }
        if modulated:
            p["adaln"] = linear(sd, pre + ".adaLN_modulation.0")
        return p

    key = f"{cfg.patch_size}-1"
    params = {
        "t_embedder": {"fc1": linear(sd, "t_embedder.mlp.0"),
                       "fc2": linear(sd, "t_embedder.mlp.2")},
        "cap_embedder": {"norm": vec("cap_embedder.0.weight"),
                         "fc": linear(sd, "cap_embedder.1")},
        "x_embedder": linear(sd, f"all_x_embedder.{key}"),
        "x_pad_token": vec("x_pad_token")[0],
        "cap_pad_token": vec("cap_pad_token")[0],
        "noise_refiner": [block(f"noise_refiner.{i}") for i in range(cfg.num_refiner_layers)],
        "context_refiner": [block(f"context_refiner.{i}", False)
                            for i in range(cfg.num_refiner_layers)],
        "layers": [block(f"layers.{i}") for i in range(cfg.num_layers)],
        "final": {"adaln": linear(sd, f"all_final_layer.{key}.adaLN_modulation.1"),
                  "linear": linear(sd, f"all_final_layer.{key}.linear")},
    }
    return to_tensors(params, device, dtype)
