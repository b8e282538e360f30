"""The speech-to-video DiT (Wan2.2-S2V) and its audio stack (port of
fairygen_tpu/models/wan/s2v.py).

  * Per-token RoPE angles from grid specs with linspace-sampled positions
    and negated (conjugate) angles for negative-time frames, built in fp64
    on the host (numpy, the JAX package's own) and kept as fp32 (cos, sin)
    tables;
  * the frame packer: 1x / 2x / 4x patchifications of the trailing motion
    latents on negative-time grids;
  * the causal audio encoder (layer-weighted wav2vec features through
    causal conv1d at stride 2, each followed by LayerNorm + SiLU) and the
    audio injector's cross-attention after the mapped blocks, with AdaLN;
  * the dual timestep: the denoised tokens take t, the reference frame's
    (and the motion tokens) t = 0; a trainable 3-way condition embedding;
  * the audio bucketing helpers (numpy).

The blocks run plain LayerNorm + per-token two-row modulation (no K1, as
in the JAX package, ``s2v.py:244-257``).  On the card with head_dim 128
the self-attention takes K2 on q and k with the S2V tables, then the
bounded attention (K3); elsewhere the plain rms -> RoPE -> attention
chain that the goldens hold.  The text cross-attention and the audio
injector's run q's rms into the bounded attention, K4 on the card (the
injector over 4 audio tokens + 1 padding token, one batch row a latent
frame).

The frame packer's 4x patchification floors the latent height and width
to multiples of 8, as upstream's stride-8 Conv3d does (at 480x832 the
latent is 60 x 104, which the JAX package's reshape refuses).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import linear, to_tensors
from ...ops.attention import LOG2E, attention
from ...ops.fused_qk import build_freqs_full, fused_qk_attention
from ...ops.norms import layer_norm, modulate, rms_norm
from ...ops.rope import rope_apply
from .dit import (WanDiTConfig, _cross_attention, _dense, _gelu_tanh, head_forward,
                  sinusoidal_embedding_1d, text_embedding, unpatchify)


@dataclasses.dataclass(frozen=True)
class S2VConfig:
    dim: int = 5120
    in_dim: int = 16
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    cond_dim: int = 16
    audio_dim: int = 1024
    num_audio_token: int = 4
    enable_adain: bool = True
    audio_inject_layers: Tuple[int, ...] = (0, 4, 8, 12, 16, 20, 24, 27, 30, 33, 36, 39)
    zip_frame_buckets: Tuple[int, int, int] = (1, 2, 16)
    motion_channels: int = 16
    num_audio_layers: int = 25  # wav2vec hidden-state layers

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    def dit_cfg(self) -> WanDiTConfig:
        return WanDiTConfig(
            dim=self.dim, in_dim=self.in_dim, ffn_dim=self.ffn_dim, out_dim=self.out_dim,
            text_dim=self.text_dim, freq_dim=self.freq_dim, eps=self.eps,
            patch_size=self.patch_size, num_heads=self.num_heads, num_layers=self.num_layers)


# ------------------------------------------------------------- rope grids
def _freq_parts(head_dim: int, theta: float = 10000.0):
    c = head_dim // 2
    d_f = c - 2 * (c // 3)
    d_hw = c // 3

    def inv(npairs):
        dim = 2 * npairs
        return 1.0 / (theta ** (np.arange(0, dim, 2)[:npairs] / dim))

    return inv(d_f), inv(d_hw), inv(d_hw)


def rope_grid_angles(grids, head_dim: int) -> np.ndarray:
    """Grid specs [(start_fhw, end_fhw, true_fhw), ...] -> per-token fp64
    angles (S, head_dim // 2); negative-time frames negated."""
    inv_f, inv_h, inv_w = _freq_parts(head_dim)
    rows = []
    for start, end, true in grids:
        f_o, h_o, w_o = start
        f, h, w = end
        t_f, t_h, t_w = true
        seq_f, seq_h, seq_w = int(f - f_o), int(h - h_o), int(w - w_o)
        if seq_f * seq_h * seq_w <= 0:
            continue
        if f_o >= 0:
            f_sam = np.linspace(f_o, t_f + f_o - 1, seq_f).astype(int)
            conj = False
        else:
            f_sam = np.linspace(-f_o, -t_f - f_o + 1, seq_f).astype(int)
            conj = True
        h_sam = np.linspace(h_o, t_h + h_o - 1, seq_h).astype(int)
        w_sam = np.linspace(w_o, t_w + w_o - 1, seq_w).astype(int)
        ang_f = np.outer(f_sam.astype(np.float64), inv_f)
        if conj:
            ang_f = -ang_f
        ang_h = np.outer(h_sam.astype(np.float64), inv_h)
        ang_w = np.outer(w_sam.astype(np.float64), inv_w)
        gf = np.broadcast_to(ang_f[:, None, None, :], (seq_f, seq_h, seq_w, ang_f.shape[1]))
        gh = np.broadcast_to(ang_h[None, :, None, :], (seq_f, seq_h, seq_w, ang_h.shape[1]))
        gw = np.broadcast_to(ang_w[None, None, :, :], (seq_f, seq_h, seq_w, ang_w.shape[1]))
        rows.append(np.concatenate([gf, gh, gw], -1).reshape(-1, head_dim // 2))
    return np.concatenate(rows, axis=0)


def angles_to_freqs(angles: np.ndarray, device="cpu") -> torch.Tensor:
    """fp64 angles (S, hd/2) -> the (2, S, hd/2) fp32 (cos, sin) tables."""
    return torch.from_numpy(np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32)
                            ).to(device)


# ------------------------------------------------------- causal conv pieces
def _causal_conv1d(p, x, stride=1):
    """x (B, T, C), w (k, C_in, C_out): front pad of k - 1 copies of the
    first frame, then the conv (fp32 accumulation, cast, bias)."""
    k = p["w"].shape[0]
    x = torch.cat([x[:, :1].expand(-1, k - 1, -1), x], dim=1)
    y = F.conv1d(x.transpose(1, 2), p["w"].permute(2, 1, 0).to(x.dtype),
                 stride=stride).transpose(1, 2)
    return y + p["b"].to(x.dtype)


def _ln_silu(y):
    y = layer_norm(y, 1e-6)
    return F.silu(y.float()).to(y.dtype)


def motion_encoder_forward(p, x, num_heads: int, need_global: bool):
    """The causal audio encoder's conv stack; x (B, T, C_in)."""
    b = x.shape[0]
    local = _causal_conv1d(p["conv1_local"], x)
    _, t, c = local.shape
    local = local.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)
    local = _ln_silu(local.reshape(b * num_heads, t, c // num_heads))
    local = _ln_silu(_causal_conv1d(p["conv2"], local, stride=2))
    local = _ln_silu(_causal_conv1d(p["conv3"], local, stride=2))
    tl = local.shape[1]
    local = local.reshape(b, num_heads, tl, -1).transpose(1, 2)  # b t n c
    pad = p["padding_tokens"].to(local.dtype).expand(b, tl, 1, local.shape[-1])
    x_local = torch.cat([local, pad], dim=-2)
    if not need_global:
        return x_local
    g = _ln_silu(_causal_conv1d(p["conv1_global"], x))
    g = _ln_silu(_causal_conv1d(p["conv2"], g, stride=2))
    g = _ln_silu(_causal_conv1d(p["conv3"], g, stride=2))
    g = _dense(p["final_linear"], g)
    return g[:, :, None], x_local  # (b, t, 1, c)


def causal_audio_encoder_forward(p, features, num_token: int, need_global: bool):
    """features (B, L, C, T) -> the encoder's (global, local) features."""
    w = F.silu(p["weights"].float())  # (1, L, 1, 1)
    w = w / w.sum(dim=1, keepdim=True)
    feat = (features.float() * w).sum(dim=1)  # (B, C, T)
    feat = feat.transpose(1, 2).to(features.dtype)
    return motion_encoder_forward(p["encoder"], feat, num_token, need_global)


# ------------------------------------------------------------ frame packing
def _patchify3d(p, x, patch):
    """Conv3d(stride = kernel) as a dense over patches: x (B, C, F, H, W)
    -> ((B, S, D), (f, h, w)), dimensions floored to the patch as the
    conv floors them."""
    B, C, F_, H, W = x.shape
    pt, ph, pw = patch
    f, h, w = F_ // pt, H // ph, W // pw
    x = x[:, :, :f * pt, :h * ph, :w * pw]
    v = x.reshape(B, C, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return _dense(p, v.reshape(B, f * h * w, C * pt * ph * pw)), (f, h, w)


def frame_packer_forward(params, cfg: S2VConfig, motion_latents, drop_motion_frames=False):
    """The frame packer over motion_latents (B, 16, T, H, W): its tokens
    (B, S_m, D) and their fp64 RoPE angles (S_m, hd/2)."""
    if drop_motion_frames:
        return (motion_latents.new_zeros((motion_latents.shape[0], 0, cfg.dim)),
                np.zeros((0, cfg.head_dim // 2)))
    zb = cfg.zip_frame_buckets
    total = sum(zb)
    b, c, t, H, W = motion_latents.shape
    padd = motion_latents.new_zeros((b, c, total, H, W))
    overlap = min(total, t)
    padd[:, :, -overlap:] = motion_latents[:, :, -overlap:]
    lat_4x = padd[:, :, :zb[2]]
    lat_2x = padd[:, :, zb[2]:zb[2] + zb[1]]
    lat_post = padd[:, :, zb[2] + zb[1]:]
    post, _ = _patchify3d(params["proj"], lat_post, (1, 2, 2))
    two, _ = _patchify3d(params["proj_2x"], lat_2x, (2, 4, 4))
    four, _ = _patchify3d(params["proj_4x"], lat_4x, (4, 8, 8))
    mot = torch.cat([post, two, four], dim=1)
    return mot, rope_grid_angles(frame_packer_grids(cfg, H, W), cfg.head_dim)


def frame_packer_grids(cfg: S2VConfig, H: int, W: int):
    """The frame packer's RoPE grid specs at a latent H x W: its 1x, 2x and
    4x buckets at negative times."""
    zb = cfg.zip_frame_buckets
    return [
        ((-zb[0], 0, 0), (-zb[0] + zb[0], H // 2, W // 2), (zb[0], H // 2, W // 2)),
        ((-(zb[0] + zb[1]), 0, 0), (-(zb[0] + zb[1]) + zb[1] // 2, H // 4, W // 4),
         (zb[1], H // 2, W // 2)),
        ((-(zb[0] + zb[1] + zb[2]), 0, 0),
         (-(zb[0] + zb[1] + zb[2]) + zb[2] // 4, H // 8, W // 8), (zb[2], H // 2, W // 2)),
    ]


# ------------------------------------------------------------------- blocks
def _two_rows(m, seq_len_x, s_total):
    """(1, 2, D) rows -> (1, S, D): the first seq_len_x tokens row 0."""
    return torch.cat([m[:, 0:1].expand(1, seq_len_x, -1),
                      m[:, 1:2].expand(1, s_total - seq_len_x, -1)], dim=1)


def s2v_dit_block(p, x, ctx, t_mod2, seq_len_x, freqs, cfg: S2VConfig, freqs_full=None):
    """One S2V block.  t_mod2 (2, 6, D): the denoise timestep's rows for the
    first seq_len_x tokens, t = 0's for the rest.  ``freqs_full``: the
    full-width tables of the fused q / k prep (K2 + K3)."""
    s_total = x.shape[1]
    mod = p["modulation"].float()[None] + t_mod2.float()  # (2, 6, D)
    parts = [_two_rows(mod[:, i][None], seq_len_x, s_total).to(x.dtype) for i in range(6)]
    s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = parts

    y = modulate(layer_norm(x, cfg.eps), s_msa, sc_msa)
    a = p["self_attn"]
    b, s, d = y.shape
    n, hd = cfg.num_heads, cfg.head_dim
    if freqs_full is not None:
        c = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32, device=y.device)
        gq = (a["norm_q"].float() * c).to(a["norm_q"].dtype)
        o = fused_qk_attention(_dense(a["q"], y), _dense(a["k"], y),
                               _dense(a["v"], y).reshape(b, s, n, hd), gq, a["norm_k"],
                               freqs_full, n, cfg.eps).reshape(b, s, d)
    else:
        q = rms_norm(_dense(a["q"], y), a["norm_q"], cfg.eps).reshape(b, s, n, hd)
        k = rms_norm(_dense(a["k"], y), a["norm_k"], cfg.eps).reshape(b, s, n, hd)
        v = _dense(a["v"], y).reshape(b, s, n, hd)
        o = attention(rope_apply(q, freqs), rope_apply(k, freqs), v,
                      bounded_logits=True).reshape(b, s, d)
    x = x + g_msa * _dense(a["o"], o)
    y = layer_norm(x, cfg.eps, p["norm3"]["w"], p["norm3"]["b"])
    x = x + _cross_attention(p["cross_attn"], y, None, n, cfg.eps, False, ctx=ctx)
    y = modulate(layer_norm(x, cfg.eps), s_mlp, sc_mlp)
    return x + g_mlp * _dense(p["ffn"]["fc2"], _gelu_tanh(_dense(p["ffn"]["fc1"], y)))


def _ada_layer_norm(p, x, temb, eps=1e-5):
    t = _dense(p["linear"], F.silu(temb.float()).to(temb.dtype))
    shift, scale = t.chunk(2, dim=-1)
    return layer_norm(x, eps) * (1 + scale[:, None]) + shift[:, None]


def _audio_inject(params, cfg: S2VConfig, block_idx, x, audio_emb_global, audio_emb,
                  seq_len_x):
    """The audio injector after block ``block_idx`` (when it is mapped):
    each latent frame's tokens cross-attend to its audio tokens."""
    inj_map = {layer: i for i, layer in enumerate(cfg.audio_inject_layers)
               if layer < cfg.num_layers}
    if block_idx not in inj_map:
        return x
    i = inj_map[block_idx]
    num_frames = audio_emb.shape[1]
    b = x.shape[0]
    tokens = x[:, :seq_len_x].reshape(b * num_frames, seq_len_x // num_frames, cfg.dim)
    if cfg.enable_adain:
        temb = audio_emb_global.reshape(b * num_frames, -1, cfg.dim)[:, 0]
        attn_in = _ada_layer_norm(params["adain"][i], tokens, temb)
    else:
        attn_in = layer_norm(tokens, 1e-6)
    audio = audio_emb.reshape(b * num_frames, -1, cfg.dim)
    res = _cross_attention(params["injector"][i], attn_in, None, cfg.num_heads, cfg.eps,
                           False, ctx=audio)
    res = res.reshape(b, seq_len_x, cfg.dim).to(x.dtype)
    return torch.cat([x[:, :seq_len_x] + res, x[:, seq_len_x:]], dim=1)


# ------------------------------------------------------------------ forward
def wan_s2v_forward(params, cfg: S2VConfig, latents, timestep, context, audio_input,
                    motion_latents=None, pose_cond=None, drop_motion_frames: bool = True,
                    motion_frames: Tuple[int, int] = (73, 19)):
    """The S2V denoiser: latents (1, C, F, H, W) whose frame 0 is the
    reference latent (returned as it came); timestep (1,); context (1, L,
    text_dim); audio_input (1, 25, audio_dim, F' - 1 video frames).
    ``drop_motion_frames`` defaults True, as upstream's forward leaves it
    (the pipeline passes False with a motion video)."""
    if latents.is_cuda and cfg.head_dim != 128:
        raise ValueError(f"the CUDA kernels need head_dim 128, got {cfg.head_dim}")
    origin_ref = latents[:, :, 0:1]
    x_lat = latents[:, :, 1:]
    ctx = text_embedding(params, context)

    rep = audio_input[..., 0:1].expand(*audio_input.shape[:-1], motion_frames[0])
    audio_full = torch.cat([rep, audio_input], dim=-1)
    aeg, aemb = causal_audio_encoder_forward(params["casual_audio_encoder"], audio_full,
                                             cfg.num_audio_token, cfg.enable_adain)
    audio_emb_global = aeg[:, motion_frames[1]:]
    merged_audio_emb = aemb[:, motion_frames[1]:]

    pose = torch.zeros_like(x_lat) if pose_cond is None else pose_cond
    x, (f, h, w) = _patchify3d(params["patch_embedding"], x_lat, cfg.patch_size)
    pc, _ = _patchify3d(params["cond_encoder"], pose, cfg.patch_size)
    x = x + pc
    seq_len_x = x.shape[1]
    ref, (rf, rh, rw) = _patchify3d(params["patch_embedding"], origin_ref, cfg.patch_size)
    x = torch.cat([x, ref], dim=1)
    mask = [np.zeros(seq_len_x, np.int64), np.ones(ref.shape[1], np.int64)]
    angles = rope_grid_angles([((0, 0, 0), (f, h, w), (f, h, w)),
                               ((30, 0, 0), (31, rh, rw), (1, rh, rw))], cfg.head_dim)
    if motion_latents is not None and not drop_motion_frames:
        mot, mot_angles = frame_packer_forward(params["frame_packer"], cfg, motion_latents)
        if mot.shape[1] > 0:
            x = torch.cat([x, mot], dim=1)
            angles = np.concatenate([angles, mot_angles], axis=0)
            mask.append(2 * np.ones(mot.shape[1], np.int64))
    freqs = angles_to_freqs(angles, x.device)
    mask = torch.from_numpy(np.concatenate(mask)).to(x.device)
    x = x + params["trainable_cond_mask"][mask].to(x.dtype)

    ts2 = torch.cat([timestep.reshape(1), torch.zeros((1,), dtype=timestep.dtype,
                                                      device=timestep.device)])
    emb = sinusoidal_embedding_1d(cfg.freq_dim, ts2).to(x.dtype)
    hdn = _dense(params["time_embed"]["fc1"], emb)
    hdn = F.silu(hdn.float()).to(hdn.dtype)
    t = _dense(params["time_embed"]["fc2"], hdn)
    tp = F.silu(t.float()).to(t.dtype)
    t_mod2 = _dense(params["time_proj"], tp).reshape(2, 6, cfg.dim)

    freqs_full = build_freqs_full(freqs) if x.is_cuda else None
    for i, blk in enumerate(params["blocks"]):
        x = s2v_dit_block(blk, x, ctx, t_mod2, seq_len_x, freqs, cfg, freqs_full=freqs_full)
        x = _audio_inject(params["audio_injector"], cfg, i, x, audio_emb_global,
                          merged_audio_emb, seq_len_x)
    x = head_forward(params["head"], x[:, :seq_len_x], t[:1], cfg.dit_cfg())
    x = unpatchify(x, (f, h, w), cfg.dit_cfg())
    return torch.cat([origin_ref, x], dim=2)


# ------------------------------------------------------------------ converter
def convert_s2v_state_dict(sd: Dict[str, np.ndarray], cfg: S2VConfig, dtype=None,
                           device="cuda"):
    """Upstream S2V state dict -> port params on ``device`` (conv1d weights
    (k, in, out), the Conv3d patchifiers as dense weights)."""
    def g(name):
        return np.asarray(sd[name])

    def conv1d(name):  # torch (out, in, k) -> (k, in, out)
        return {"w": g(name + ".weight").transpose(2, 1, 0), "b": g(name + ".bias")}

    def conv3d_as_dense(name):  # (D, C, pt, ph, pw) -> (C·pt·ph·pw, D)
        w = g(name + ".weight")
        return {"w": w.transpose(1, 2, 3, 4, 0).reshape(-1, w.shape[0]),
                "b": g(name + ".bias")}

    def attn(pre):
        p = {k: linear(sd, f"{pre}.{k}") for k in ("q", "k", "v", "o")}
        p["norm_q"] = g(pre + ".norm_q.weight")
        p["norm_k"] = g(pre + ".norm_k.weight")
        return p

    D = cfg.dim
    blocks = [{"self_attn": attn(f"blocks.{i}.self_attn"),
               "cross_attn": attn(f"blocks.{i}.cross_attn"),
               "norm3": {"w": g(f"blocks.{i}.norm3.weight"), "b": g(f"blocks.{i}.norm3.bias")},
               "ffn": {"fc1": linear(sd, f"blocks.{i}.ffn.0"),
                       "fc2": linear(sd, f"blocks.{i}.ffn.2")},
               "modulation": g(f"blocks.{i}.modulation").reshape(6, D)}
              for i in range(cfg.num_layers)]

    def motion_encoder(pre, need_global):
        p = {"conv1_local": conv1d(pre + ".conv1_local.conv"),
             "conv2": conv1d(pre + ".conv2.conv"), "conv3": conv1d(pre + ".conv3.conv"),
             "padding_tokens": g(pre + ".padding_tokens")}
        if need_global:
            p["conv1_global"] = conv1d(pre + ".conv1_global.conv")
            p["final_linear"] = linear(sd, pre + ".final_linear")
        return p

    n_inject = len([layer for layer in cfg.audio_inject_layers if layer < cfg.num_layers])
    params = {
        "patch_embedding": conv3d_as_dense("patch_embedding"),
        "cond_encoder": conv3d_as_dense("cond_encoder"),
        "text_embed": {"fc1": linear(sd, "text_embedding.0"),
                       "fc2": linear(sd, "text_embedding.2")},
        "time_embed": {"fc1": linear(sd, "time_embedding.0"),
                       "fc2": linear(sd, "time_embedding.2")},
        "time_proj": linear(sd, "time_projection.1"),
        "blocks": blocks,
        "head": {**linear(sd, "head.head"), "modulation": g("head.modulation").reshape(2, D)},
        "trainable_cond_mask": g("trainable_cond_mask.weight"),
        "casual_audio_encoder": {
            "weights": g("casual_audio_encoder.weights"),
            "encoder": motion_encoder("casual_audio_encoder.encoder", cfg.enable_adain)},
        "audio_injector": {
            "injector": [attn(f"audio_injector.injector.{i}") for i in range(n_inject)],
            "adain": [{"linear": linear(sd, f"audio_injector.injector_adain_layers.{i}.linear")}
                      for i in range(n_inject)] if cfg.enable_adain else []},
        "frame_packer": {"proj": conv3d_as_dense("frame_packer.proj"),
                         "proj_2x": conv3d_as_dense("frame_packer.proj_2x"),
                         "proj_4x": conv3d_as_dense("frame_packer.proj_4x")},
    }
    return to_tensors(params, device, dtype)


# ------------------------------------------------------- audio bucket utils
def linear_interpolation_np(features: np.ndarray, input_fps: float, output_fps: float,
                            output_len=None) -> np.ndarray:
    """align_corners linear resample over time of features (B, T, C)."""
    b, t, c = features.shape
    if output_len is None:
        output_len = int(t / float(input_fps) * output_fps)
    if output_len == 1 or t == 1:
        idx = np.zeros(output_len)
    else:
        idx = np.linspace(0, t - 1, output_len)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    frac = (idx - lo)[None, :, None]
    return features[:, lo] * (1 - frac) + features[:, hi] * frac


def get_audio_embed_bucket_fps(audio_embed: np.ndarray, fps=16, batch_frames=81, m=0,
                               video_rate=30):
    """Per-frame audio features (L, T, C) at ``video_rate`` -> the buckets
    of ``batch_frames`` video frames at ``fps``, and their count."""
    num_layers, audio_frame_num, audio_dim = audio_embed.shape
    return_all_layers = num_layers > 1
    scale = video_rate / fps
    min_batch_num = int(audio_frame_num / (batch_frames * scale)) + 1
    bucket_num = min_batch_num * batch_frames
    padd = math.ceil(min_batch_num * batch_frames / fps * video_rate) - audio_frame_num
    total = audio_frame_num + padd
    time_points = np.linspace(0.0, bucket_num / fps, bucket_num, endpoint=False)
    batch_idx = np.clip(np.round(time_points * video_rate).astype(int), 0, total - 1)
    stride = int(video_rate / fps)
    out = []
    for bi in batch_idx:
        if bi < audio_frame_num:
            chosen = list(range(bi - m * stride, bi + (m + 1) * stride, stride))
            chosen = [min(max(c, 0), audio_frame_num - 1) for c in chosen]
            emb = (audio_embed[:, chosen].reshape(num_layers, -1) if return_all_layers
                   else audio_embed[0][chosen].reshape(-1))
        else:
            emb = (np.zeros((num_layers, audio_dim * (2 * m + 1))) if return_all_layers
                   else np.zeros(audio_dim * (2 * m + 1)))
        out.append(emb)
    return np.stack(out), min_batch_num
