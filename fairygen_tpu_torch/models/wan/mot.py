"""VAP ("video as prompt"): the mixture-of-transformers side branch (port of
fairygen_tpu/models/wan/mot.py; upstream ``wan_video_mot.py``).

At each of the branch's mapped main layers the main tokens and the
reference video's tokens attend jointly, one attention over the
concatenated sequence, each side with its own modulation, norms,
projections and FFN; the reference frames take RoPE frame positions
−f..−1, before the generated clip.  The other main layers are the DiT's
``dit_block`` without full-width RoPE tables.

On the card: the joint layers keep the JAX package's plain LayerNorm +
modulation and rms -> RoPE chain, and their attention is the generic one
without ``bounded_logits`` (K5 over the joint keys, which pass 1024); the
cross-attentions are q's rms into the bounded attention (K4 over the text
and CLIP keys).  The other layers run K1 and the plain q / k chain into K3
and K4, as the VACE blocks do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...core.params import linear, to_tensors
from ...ops.attention import attention
from ...ops.norms import layer_norm, modulate, rms_norm
from ...ops.rope import build_freqs_grid, precompute_freqs_3d, rope_apply
from .aux_models import _image_kv
from .dit import (IMAGE_TOKENS, WanDiTConfig, _cross_attention, _dense, _gelu_tanh, dit_block,
                  head_forward, img_embedding, patchify, text_embedding, time_embedding,
                  unpatchify)


@dataclasses.dataclass(frozen=True)
class MotConfig:
    mot_layers: Tuple[int, ...] = (0, 4, 8, 12, 16, 20, 24, 28, 32, 36)
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    has_image_input: bool = True
    dim: int = 5120
    num_heads: int = 40
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    in_dim: int = 36
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    def dit_cfg(self) -> WanDiTConfig:
        return WanDiTConfig(
            dim=self.dim, in_dim=self.in_dim, ffn_dim=self.ffn_dim, out_dim=self.in_dim,
            text_dim=self.text_dim, freq_dim=self.freq_dim, eps=self.eps,
            patch_size=self.patch_size, num_heads=self.num_heads,
            num_layers=len(self.mot_layers), has_image_input=self.has_image_input)


def build_freqs_grid_mot(head_dim: int, f: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """The (cos, sin) grid (2, f·h·w, head_dim/2) with frame positions
    −f..−1, angles in fp64, kept as fp32."""
    d_f = head_dim - 2 * (head_dim // 3)
    d_hw = head_dim // 3

    def inv(dim):
        return 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))

    ang_f = np.outer(np.arange(-f, 0, dtype=np.float64), inv(d_f))
    ang_h = np.outer(np.arange(h, dtype=np.float64), inv(d_hw))
    ang_w = np.outer(np.arange(w, dtype=np.float64), inv(d_hw))
    gf = np.broadcast_to(ang_f[:, None, None, :], (f, h, w, ang_f.shape[1]))
    gh = np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ang_h.shape[1]))
    gw = np.broadcast_to(ang_w[None, None, :, :], (f, h, w, ang_w.shape[1]))
    grid = np.concatenate([gf, gh, gw], axis=-1).reshape(f * h * w, -1)
    return torch.from_numpy(np.stack([np.cos(grid), np.sin(grid)]).astype(np.float32)).to(device)


def _split(ctx, has_image_input):
    """The cross-attention's (image, text) context rows."""
    if has_image_input:
        return ctx[:, :IMAGE_TOKENS], ctx[:, IMAGE_TOKENS:]
    return None, ctx


def _branch_cross(ca, y, ctx, cfg: MotConfig):
    img, txt = _split(ctx, cfg.has_image_input)
    img_kv = None if img is None else _image_kv(ca, img, cfg.dit_cfg())
    return _cross_attention(ca, y, None, cfg.num_heads, cfg.eps, False, img_kv, txt)


def _qkv(a, y, freqs, cfg: MotConfig):
    b, s, _ = y.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = rms_norm(_dense(a["q"], y), a["norm_q"], cfg.eps).reshape(b, s, n, hd)
    k = rms_norm(_dense(a["k"], y), a["norm_k"], cfg.eps).reshape(b, s, n, hd)
    v = _dense(a["v"], y).reshape(b, s, n, hd)
    return rope_apply(q, freqs), rope_apply(k, freqs), v


def mot_joint_block(wan_p, mot_p, x, ctx, t_mod, freqs, x_mot, ctx_mot, t_mod_mot, freqs_mot,
                    cfg: MotConfig):
    """A mapped layer: the main block ``wan_p`` and its branch block
    ``mot_p`` with one self-attention over [main; branch] tokens, then each
    side's cross-attention and FFN.  t_mod / t_mod_mot (B, 1, 6, D).
    Returns (x, x_mot)."""
    b, s, d = x.shape
    mod = (wan_p["modulation"][None, None].float() + t_mod.float()).to(x.dtype)
    s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = [mod[:, :, i] for i in range(6)]
    mod_m = (mot_p["modulation"][None, None].float() + t_mod_mot.float()).to(x.dtype)
    s_msa_m, sc_msa_m, g_msa_m, c_shift_m, c_scale_m, c_gate_m = [mod_m[:, :, i]
                                                                  for i in range(6)]

    a1, am = wan_p["self_attn"], mot_p["self_attn"]
    q, k, v = _qkv(a1, modulate(layer_norm(x, cfg.eps), s_msa, sc_msa), freqs, cfg)
    qm, km, vm = _qkv(am, modulate(layer_norm(x_mot, cfg.eps), s_msa_m, sc_msa_m), freqs_mot,
                      cfg)
    o = attention(torch.cat([q, qm], dim=1), torch.cat([k, km], dim=1),
                  torch.cat([v, vm], dim=1))
    x = x + g_msa * _dense(a1["o"], o[:, :s].reshape(b, s, d))
    x_mot = x_mot + g_msa_m * _dense(am["o"], o[:, s:].reshape(b, x_mot.shape[1], d))

    y = layer_norm(x, cfg.eps, wan_p["norm3"]["w"], wan_p["norm3"]["b"])
    x = x + _branch_cross(wan_p["cross_attn"], y, ctx, cfg)
    y = modulate(layer_norm(x, cfg.eps), s_mlp, sc_mlp)
    x = x + g_mlp * _dense(wan_p["ffn"]["fc2"], _gelu_tanh(_dense(wan_p["ffn"]["fc1"], y)))

    ym = layer_norm(x_mot, cfg.eps, mot_p["norm3"]["w"], mot_p["norm3"]["b"])
    x_mot = x_mot + _branch_cross(mot_p["cross_attn"], ym, ctx_mot, cfg)
    ym = modulate(layer_norm(x_mot, cfg.eps), c_shift_m, c_scale_m)
    ff = _dense(mot_p["ffn"]["fc2"], _gelu_tanh(_dense(mot_p["ffn"]["fc1"], ym)))
    return x, x_mot + c_gate_m * ff


def mot_prepare(params, cfg: MotConfig, vap_hidden_state, context_vap, vap_clip_feature=None):
    """The branch's inputs: the reference video's patch tokens, its clean
    timestep (1) embedded (t_mot, t_mod_mot), its context (with the CLIP
    tokens in front for an image branch) and its RoPE grid."""
    x_mot, (f, h, w) = patchify({"patch_embed": params["patch_embedding"]}, cfg.dit_cfg(),
                                vap_hidden_state)
    clean_t = torch.ones((vap_hidden_state.shape[0],), dtype=torch.float32,
                         device=vap_hidden_state.device)
    t_mot, t_mod_mot = time_embedding(params, cfg.dit_cfg(), clean_t)
    ctx = text_embedding(params, context_vap)
    if cfg.has_image_input and vap_clip_feature is not None:
        ctx = torch.cat([img_embedding(params, vap_clip_feature), ctx], dim=1)
    freqs_mot = build_freqs_grid_mot(cfg.head_dim, f, h, w, device=x_mot.device)
    return x_mot, ctx, t_mod_mot[:, None], freqs_mot, t_mot


def wan_dit_forward_vap(dit_params, dit_cfg: WanDiTConfig, mot_params, cfg: MotConfig, latents,
                        timestep, context, *, clip_feature=None, y=None, vap_hidden_state=None,
                        context_vap=None, vap_clip_feature=None):
    """The denoiser forward with the VAP branch: the main DiT's blocks, each
    mapped one joint with its branch block.  As in the JAX package (and
    upstream, whose VAP preamble overwrites ``t``), the output head is
    modulated by the branch's clean-timestep embedding, not the denoising
    one."""
    if latents.is_cuda and dit_cfg.head_dim != 128:
        raise ValueError(f"the CUDA kernels need head_dim 128, got {dit_cfg.head_dim}")
    _, t_mod = time_embedding(dit_params, dit_cfg, timestep)
    t_mod = t_mod[:, None]
    ctx = text_embedding(dit_params, context)
    x = latents
    if y is not None and dit_cfg.require_vae_embedding:
        x = torch.cat([x, y], dim=1)
    if clip_feature is not None and dit_cfg.require_clip_embedding:
        ctx = torch.cat([img_embedding(dit_params, clip_feature), ctx], dim=1)
    x, grid = patchify(dit_params, dit_cfg, x)
    freqs = build_freqs_grid(precompute_freqs_3d(dit_cfg.head_dim), *grid, device=x.device)
    x_mot, ctx_mot, t_mod_mot, freqs_mot, t_mot = mot_prepare(
        mot_params, cfg, vap_hidden_state, context_vap, vap_clip_feature)
    img, txt = _split(ctx, dit_cfg.has_image_input)

    mapping = {layer: n for n, layer in enumerate(cfg.mot_layers)}
    for i, blk in enumerate(dit_params["blocks"]):
        if i in mapping:
            x, x_mot = mot_joint_block(blk, mot_params["blocks"][mapping[i]], x, ctx, t_mod,
                                       freqs, x_mot, ctx_mot, t_mod_mot, freqs_mot, cfg)
        else:
            img_kv = None if img is None else _image_kv(blk["cross_attn"], img, dit_cfg)
            x = dit_block(blk, x, t_mod, freqs, None, dit_cfg, None, None, img_kv, txt)
    x = head_forward(dit_params["head"], x, t_mot, dit_cfg)
    return unpatchify(x, grid, dit_cfg)


def convert_mot_state_dict(sd: Dict[str, Any], cfg: MotConfig, dtype=None, device="cuda"):
    """Upstream MoT state dict (patch_embedding, text_embedding,
    time_embedding, time_projection, blocks.N over ``mot_layers``, img_emb)
    -> port params on ``device``."""
    def g(name):
        return np.asarray(sd[name])

    def attn(pre, img=False):
        p = {k: linear(sd, f"{pre}.{k}") for k in ("q", "k", "v", "o")}
        p["norm_q"] = g(pre + ".norm_q.weight")
        p["norm_k"] = g(pre + ".norm_k.weight")
        if img:
            p["k_img"] = linear(sd, pre + ".k_img")
            p["v_img"] = linear(sd, pre + ".v_img")
            p["norm_k_img"] = g(pre + ".norm_k_img.weight")
        return p

    D = cfg.dim
    pe = g("patch_embedding.weight")
    blocks = [{"self_attn": attn(f"blocks.{i}.self_attn"),
               "cross_attn": attn(f"blocks.{i}.cross_attn", cfg.has_image_input),
               "norm3": {"w": g(f"blocks.{i}.norm3.weight"), "b": g(f"blocks.{i}.norm3.bias")},
               "ffn": {"fc1": linear(sd, f"blocks.{i}.ffn.0"),
                       "fc2": linear(sd, f"blocks.{i}.ffn.2")},
               "modulation": g(f"blocks.{i}.modulation").reshape(6, D)}
              for i in range(len(cfg.mot_layers))]
    params: Dict[str, Any] = {
        "patch_embedding": {"w": pe.transpose(1, 2, 3, 4, 0).reshape(-1, D),
                            "b": g("patch_embedding.bias")},
        "text_embed": {"fc1": linear(sd, "text_embedding.0"),
                       "fc2": linear(sd, "text_embedding.2")},
        "time_embed": {"fc1": linear(sd, "time_embedding.0"),
                       "fc2": linear(sd, "time_embedding.2")},
        "time_proj": linear(sd, "time_projection.1"),
        "blocks": blocks,
    }
    if cfg.has_image_input:
        params["img_emb"] = {
            "norm1": {"w": g("img_emb.proj.0.weight"), "b": g("img_emb.proj.0.bias")},
            "fc1": linear(sd, "img_emb.proj.1"), "fc2": linear(sd, "img_emb.proj.3"),
            "norm2": {"w": g("img_emb.proj.4.weight"), "b": g("img_emb.proj.4.bias")}}
        if "img_emb.emb_pos" in sd:
            params["img_emb"]["pos"] = g("img_emb.emb_pos")
    return to_tensors(params, device, dtype)
