"""The LongCat-Video DiT (port of fairygen_tpu/models/wan/longcat.py;
upstream ``LongCatVideoTransformer3DModel``): 48 single-stream blocks of
width 4096, 32 heads, with

- per-frame timesteps: ``t`` spread over the latent frames with the
  conditioning frames' zeroed, and every modulation (6-way in the blocks,
  2-way in the final layer) per frame, in fp32;
- 3D RoPE with the split dim_t = hd − 4·(hd//6), dim_h = dim_w = 2·(hd//6)
  (44 / 42 / 42 at hd 128), rotating interleaved pairs;
- in cond mode, conditioning-frame queries attend to the conditioning
  keys only and noise-frame queries to all keys (a call with Sq ≠ Sk);
  the conditioning frames skip the cross-attention, whose projection runs
  before their zero rows go in (its bias stays out of them);
- fp32 norms and modulation and a SwiGLU FFN.  The output is fp32.

On the card the self-attention is the bounded form (K3; q and k are
rms-normed), the cross-attention over the text the generic one (K4's max
form over 512 keys); the rest, RoPE included, is plain PyTorch, as in the
JAX package.  Dense weights are cast to the input's dtype, as the JAX
module's ``_dense`` does: the time MLP, the modulations and the final
layer run in fp32 on bf16 weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors
from ...ops.attention import attention
from ...ops.norms import rms_norm
from ...ops.rope import apply_interleaved_rope


@dataclasses.dataclass(frozen=True)
class LongCatDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 4096
    depth: int = 48
    num_heads: int = 32
    caption_channels: int = 4096
    mlp_ratio: int = 4
    adaln_tembed_dim: int = 512
    freq_dim: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_hidden(self):
        h = int(2 * (self.hidden_size * self.mlp_ratio) / 3)
        return 256 * ((h + 255) // 256)

    @staticmethod
    def longcat() -> "LongCatDiTConfig":
        return LongCatDiTConfig()

    @staticmethod
    def tiny(**over) -> "LongCatDiTConfig":
        base = dict(in_channels=4, out_channels=4, hidden_size=96, depth=2, num_heads=4,
                    caption_channels=48, adaln_tembed_dim=64, freq_dim=32)
        base.update(over)
        return LongCatDiTConfig(**base)


def _dense(p, x):
    """x @ w + b with w and b cast to x's dtype."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _ln_fp32(x, eps=1e-6, w=None, b=None):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float() + b.float()
    return y


def longcat_rope_tables(grid: Tuple[int, int, int], head_dim: int, theta: float = 10000.0):
    """(L, head_dim/2) fp32 cos / sin tables of the interleaved pairs, the
    angles in fp64."""
    t, h, w = grid
    dim_t = head_dim - 4 * (head_dim // 6)
    dim_h = dim_w = 2 * (head_dim // 6)

    def axis(n, d):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64)[: d // 2] / d)
        return np.einsum("n,f->nf", np.arange(n, dtype=np.float64), freqs)

    ft = np.broadcast_to(axis(t, dim_t)[:, None, None, :], (t, h, w, dim_t // 2))
    fh = np.broadcast_to(axis(h, dim_h)[None, :, None, :], (t, h, w, dim_h // 2))
    fw = np.broadcast_to(axis(w, dim_w)[None, None, :, :], (t, h, w, dim_w // 2))
    ang = np.concatenate([ft, fh, fw], -1).reshape(t * h * w, -1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def longcat_block(p, x, ctx, t_mod6, cos, sin, cfg: LongCatDiTConfig, grid, num_cond: int):
    """One single-stream block; t_mod6: six (B, T, 1, C) fp32 modulations."""
    b, n, c = x.shape
    T = grid[0]
    per = n // T
    nh, hd = cfg.num_heads, cfg.head_dim
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = t_mod6

    def modulate(v, shift, scale):
        vf = _ln_fp32(v.float().reshape(b, T, per, c), cfg.eps)
        return (vf * (scale + 1) + shift).reshape(b, n, c).to(v.dtype)

    def gated(v, gate, y):
        return (v.float() + (gate * y.float().reshape(b, T, per, c)).reshape(b, n, c)).to(v.dtype)

    qkv = _dense(p["qkv"], modulate(x, sh_a, sc_a)).reshape(b, n, 3, nh, hd)
    q = apply_interleaved_rope(rms_norm(qkv[:, :, 0], p["q_norm"], cfg.eps), cos, sin)
    k = apply_interleaved_rope(rms_norm(qkv[:, :, 1], p["k_norm"], cfg.eps), cos, sin)
    v = qkv[:, :, 2]
    nc = num_cond * per
    if num_cond:
        o = torch.cat([attention(q[:, :nc], k[:, :nc], v[:, :nc], bounded_logits=True),
                       attention(q[:, nc:], k, v, bounded_logits=True)], dim=1)
    else:
        o = attention(q, k, v, bounded_logits=True)
    x = gated(x, g_a, _dense(p["proj"], o.reshape(b, n, nh * hd)))

    yq = _ln_fp32(x, cfg.eps, p["crs_norm"]["w"], p["crs_norm"]["b"]).to(x.dtype)
    qx = rms_norm(_dense(p["crs_q"], yq[:, nc:]).reshape(b, n - nc, nh, hd), p["crs_q_norm"],
                  cfg.eps)
    kvx = _dense(p["crs_kv"], ctx).reshape(b, -1, 2, nh, hd)
    kx = rms_norm(kvx[:, :, 0], p["crs_k_norm"], cfg.eps)
    crs = _dense(p["crs_proj"], attention(qx, kx, kvx[:, :, 1]).reshape(b, n - nc, nh * hd))
    if num_cond:  # the projection before the zero rows: its bias stays out of them
        crs = torch.cat([crs.new_zeros((b, nc, c)), crs], dim=1)
    x = x + crs

    y = modulate(x, sh_m, sc_m)
    ff = _dense(p["w2"], F.silu(_dense(p["w1"], y)) * _dense(p["w3"], y))
    return gated(x, g_m, ff)


def longcat_dit_forward(params, cfg: LongCatDiTConfig, latents, timestep, context,
                        num_cond_latents: int = 0):
    """latents (B, C, T, H, W), timestep (B,), context (B, L,
    caption_channels) -> the velocity (B, C, T, H, W) in fp32, before the
    pipeline's negation."""
    if latents.is_cuda and cfg.head_dim != 128:
        raise ValueError(f"the CUDA kernels need head_dim 128, got {cfg.head_dim}")
    b, c, T, H, W = latents.shape
    pt, ph, pw = cfg.patch_size
    nt, nh_, nw = T // pt, H // ph, W // pw
    d = cfg.hidden_size
    dev = latents.device

    ts = timestep[:, None].expand(b, nt).float()
    if num_cond_latents:
        ts = ts * (torch.arange(nt, device=dev)[None, :] >= num_cond_latents)
    half = cfg.freq_dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=dev)
                      / half)
    ang = ts.reshape(-1)[:, None] * freqs[None, :]
    sinus = torch.cat([torch.cos(ang), torch.sin(ang)], -1)
    t_emb = _dense(params["t_mlp"]["fc2"], F.silu(_dense(params["t_mlp"]["fc1"], sinus)))
    t_emb = t_emb.reshape(b, nt, cfg.adaln_tembed_dim)

    ctx = _dense(params["y_mlp"]["fc2"], F.gelu(
        _dense(params["y_mlp"]["fc1"], context.to(latents.dtype)), approximate="tanh"))

    x = latents.reshape(b, c, nt, pt, nh_, ph, nw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    x = _dense(params["x_embedder"], x.reshape(b, nt * nh_ * nw, c * pt * ph * pw))
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in longcat_rope_tables((nt, nh_, nw), cfg.head_dim))

    def mods(p_adaln, n_chunks):
        m = _dense(p_adaln, F.silu(t_emb))  # (B, T, n·C) fp32
        return m[:, :, None, :].chunk(n_chunks, dim=-1)

    for blk in params["blocks"]:
        x = longcat_block(blk, x, ctx, mods(blk["adaln"], 6), cos, sin, cfg, (nt, nh_, nw),
                          num_cond_latents)

    shift, scale = mods(params["final"]["adaln"], 2)
    per = nh_ * nw
    xf = _ln_fp32(x.float().reshape(b, nt, per, d), cfg.eps)
    xf = (xf * (scale + 1) + shift).reshape(b, nt * per, d)
    out = _dense(params["final"]["linear"], xf)
    out = out.reshape(b, nt, nh_, nw, pt, ph, pw, cfg.out_channels)
    return out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(b, cfg.out_channels, T, H, W)


# ------------------------------------------------------------------ convert
def convert_longcat_dit_state_dict(sd: Dict[str, Any], cfg: LongCatDiTConfig, dtype=None,
                                   device="cuda"):
    """Upstream LongCat-Video DiT state dict -> port params on ``device``
    (blocks as a list of ``cfg.depth`` dicts)."""
    def lin(name):
        p = {"w": np.asarray(sd[name + ".weight"]).T}
        if name + ".bias" in sd:
            p["b"] = np.asarray(sd[name + ".bias"])
        return p

    def vec(name):
        return np.asarray(sd[name + ".weight"])

    def block(i):
        pre = f"blocks.{i}"
        return {
            "adaln": lin(pre + ".adaLN_modulation.1"), "qkv": lin(pre + ".attn.qkv"),
            "q_norm": vec(pre + ".attn.q_norm"), "k_norm": vec(pre + ".attn.k_norm"),
            "proj": lin(pre + ".attn.proj"),
            "crs_norm": {"w": vec(pre + ".pre_crs_attn_norm"),
                         "b": np.asarray(sd[pre + ".pre_crs_attn_norm.bias"])},
            "crs_q": lin(pre + ".cross_attn.q_linear"),
            "crs_kv": lin(pre + ".cross_attn.kv_linear"),
            "crs_q_norm": vec(pre + ".cross_attn.q_norm"),
            "crs_k_norm": vec(pre + ".cross_attn.k_norm"),
            "crs_proj": lin(pre + ".cross_attn.proj"),
            "w1": lin(pre + ".ffn.w1"), "w2": lin(pre + ".ffn.w2"), "w3": lin(pre + ".ffn.w3"),
        }

    pw = np.asarray(sd["x_embedder.proj.weight"])  # (E, C, pt, ph, pw)
    params = {
        "x_embedder": {"w": pw.reshape(pw.shape[0], -1).T,
                       "b": np.asarray(sd["x_embedder.proj.bias"])},
        "t_mlp": {"fc1": lin("t_embedder.mlp.0"), "fc2": lin("t_embedder.mlp.2")},
        "y_mlp": {"fc1": lin("y_embedder.y_proj.0"), "fc2": lin("y_embedder.y_proj.2")},
        "blocks": [block(i) for i in range(cfg.depth)],
        "final": {"adaln": lin("final_layer.adaLN_modulation.1"),
                  "linear": lin("final_layer.linear")},
    }
    return to_tensors(params, device, dtype)
