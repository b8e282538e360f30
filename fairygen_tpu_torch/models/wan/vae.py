"""Wan causal 3D video VAEs: Wan2.2's "VAE38" (z 48, 2x2 pixel patches)
and the Wan2.1 VAE (z 16; ``arch="v1"``) (port of
fairygen_tpu/models/wan/vae.py).  The Wan2.1 networks are plain residual
stacks and resamples without VAE38's averaging and duplicating shortcuts,
and their decoder's spatial upsample halves the channels.

Tensors are channels-first (B, C, T, H, W) inside, as PyTorch's
convolutions want them; conv weights are (C_out, C_in, kt, kh, kw) /
(C_out, C_in, kh, kw).  The public ``vae38_encode``/``vae38_decode`` keep
the JAX package's BCTHW interface.

Full-sequence mode (``CacheBank("full")``) runs the causal network as one
convolution program: a CausalConv3d is a conv with a 2-frame front zero
pad, the encoder's time downsample passes the first frame through, the
decoder's time upsample doubles every frame after the first.  The "init" /
"step" modes of :class:`CacheBank` carry the last conv inputs from one
temporal chunk to the next: ``streaming=True`` runs the network chunk by
chunk ([1, 4, 4, ...] pixel frames on encode, ``frames_per_chunk`` latent
frames on decode after a one-frame first chunk), so activation memory
stays that of a chunk (same math; convolutions over other frame counts
may sum in another order).  The channel RMS norm + SiLU runs through
K11 (``ops.fused_norms.fused_vae_rms_silu``, its plain version on the
CPU) over channel-last rows, in both VAEs at every width (96 to 384 in
the Wan2.1 VAE).  The output keeps that layout, which
cuDNN's NHWC convolutions take without a conversion (on an H100 the
streamed decode is ~3% faster so; with the output transposed back it is
no faster than the plain chain).  The JAX package keeps the plain norm
for a reason of the TPU's layouts.  The convolutions are
``torch.nn.functional`` calls: no Pallas kernel covers them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors
from ...ops.fused_norms import fused_vae_rms_silu

VAE38_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], dtype=np.float32)

VAE38_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], dtype=np.float32)


VAE16_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], dtype=np.float32)

VAE16_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 160
    z_dim: int = 48
    dec_dim: int = 256
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    patch_size: int = 2  # pixel patches (VAE38); 1 for the Wan2.1 VAE
    in_channels: int = 3
    arch: str = "38"  # "38" (Wan2.2, z 48) | "v1" (Wan2.1, z 16)

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))

    @property
    def enc_dims(self):
        return [self.dim * u for u in (1,) + tuple(self.dim_mult)]

    @property
    def dec_dims(self):
        return [self.dec_dim * u for u in (self.dim_mult[-1],) + tuple(reversed(self.dim_mult))]

    @property
    def upsampling_factor(self):
        return 8 * self.patch_size

    @property
    def conv_in_channels(self):
        return self.in_channels * self.patch_size ** 2

    @staticmethod
    def wan22_38() -> "WanVAEConfig":
        return WanVAEConfig()

    @staticmethod
    def wan21_16() -> "WanVAEConfig":
        """The Wan2.1 causal VAE (upstream WanVideoVAE)."""
        return WanVAEConfig(dim=96, z_dim=16, dec_dim=96, patch_size=1, arch="v1")

    @staticmethod
    def tiny(**over) -> "WanVAEConfig":
        base = dict(dim=8, z_dim=4, dec_dim=8, num_res_blocks=1)
        base.update(over)
        return WanVAEConfig(**base)

    @staticmethod
    def tiny_v1(**over) -> "WanVAEConfig":
        base = dict(dim=8, z_dim=4, dec_dim=8, num_res_blocks=1, patch_size=1, arch="v1")
        base.update(over)
        return WanVAEConfig(**base)


def latent_stats(cfg: WanVAEConfig):
    """The latent mean and std (numpy, ``z_dim`` long) the encode
    normalises by: the Wan2.1 VAE's for ``arch="v1"``, else VAE38's."""
    mean, std = (VAE16_MEAN, VAE16_STD) if cfg.arch == "v1" else (VAE38_MEAN, VAE38_STD)
    return mean[: cfg.z_dim].copy(), std[: cfg.z_dim].copy()


class CacheBank:
    """Temporal-chunk cache in traversal order.

    "full": no caching (causal zero padding everywhere).
    "init": first chunk — record the cache entries it creates (``out``).
    "step": later chunks — consume ``entries`` in order, record new ones.
    """

    def __init__(self, mode: str, entries: Optional[List] = None):
        if mode not in ("full", "init", "step"):
            raise ValueError(mode)
        self.mode = mode
        self.entries = entries or []
        self.idx = 0
        self.out: List = []

    @property
    def streaming(self):
        return self.mode != "full"

    def pull(self):
        e = self.entries[self.idx]
        self.idx += 1
        return e

    def push(self, value):
        self.out.append(value)


# ------------------------------------------------------------------ primitives
def _conv3d(x, p, stride_t=1, spatial_pad=0):
    y = F.conv3d(x, p["w"].to(x.dtype), None, stride=(stride_t, 1, 1),
                 padding=(0, spatial_pad, spatial_pad))
    return y + p["b"].to(x.dtype)[:, None, None, None]


def _conv2d(x, p, stride=1):
    y = F.conv2d(x, p["w"].to(x.dtype), None, stride=stride)
    return y + p["b"].to(x.dtype)[:, None, None]


def causal_conv3d(p, x, cache: CacheBank, t_pad: int, spatial_pad: int = 0):
    """CausalConv3d: time front-padded by 2·t_pad zero frames (or the
    cached frames of the previous chunk when streaming)."""
    if t_pad == 0:
        return _conv3d(x, p, spatial_pad=spatial_pad)
    if not cache.streaming:
        x = F.pad(x, (0, 0, 0, 0, 2 * t_pad, 0))
        return _conv3d(x, p, spatial_pad=spatial_pad)
    if cache.mode == "init":
        prev = x.new_zeros(x.shape[:2] + (2 * t_pad,) + x.shape[3:])
    else:
        prev = cache.pull()
    eff = torch.cat([prev, x], dim=2)
    cache.push(eff[:, :, -2 * t_pad:])
    return _conv3d(eff, p, spatial_pad=spatial_pad)


def vae_rms_norm(x, gamma):
    """F.normalize over channels · sqrt(C) · gamma, fp32 inside."""
    xf = x.float()
    n = xf.pow(2).sum(1, keepdim=True).sqrt()
    y = xf / n.clamp_min(1e-12) * (x.shape[1] ** 0.5)
    g = gamma.float().reshape((1, -1) + (1,) * (x.dim() - 2))
    return (y * g).to(x.dtype)


def _norm_silu(gamma, x):
    """vae_rms_norm -> SiLU of (B, C, T, H, W) x through K11; the result
    has x's shape with channel-last strides."""
    y = fused_vae_rms_silu(x.permute(0, 2, 3, 4, 1).contiguous(), gamma)
    return y.permute(0, 4, 1, 2, 3)


def residual_block(p, x, cache: CacheBank):
    h = x
    if "shortcut" in p:
        h = causal_conv3d(p["shortcut"], x, cache, t_pad=0)
    y = _norm_silu(p["norm1"], x)
    y = causal_conv3d(p["conv1"], y, cache, t_pad=1, spatial_pad=1)
    y = _norm_silu(p["norm2"], y)
    y = causal_conv3d(p["conv2"], y, cache, t_pad=1, spatial_pad=1)
    return y + h


def _frames_to_batch(x):
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w), (b, t)


def _batch_to_frames(y, bt):
    b, t = bt
    return y.reshape((b, t) + y.shape[1:]).permute(0, 2, 1, 3, 4)


def attention_block(p, x):
    """Single-head per-frame spatial self-attention."""
    y, bt = _frames_to_batch(x)
    n, c, h, w = y.shape
    qkv = _conv2d(vae_rms_norm(y, p["norm"]), p["qkv"])
    qkv = qkv.reshape(n, 3 * c, h * w).transpose(1, 2)
    q, k, v = qkv.split(c, dim=-1)
    logits = torch.matmul(q, k.transpose(1, 2)).float() * (c ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(n, c, h, w)
    o = _conv2d(o, p["proj"])
    return _batch_to_frames(y + o, bt)


def _upsample2x_conv3x3_subpixel(x, p):
    """conv3x3(nearest-2x-upsample(x)) without the upsample: each output
    pixel sees a 2x2 neighbourhood of the input, so the op is a stride-2
    transposed conv with the 4x4 kernel of duplicated-tap sums
    [k0, k0+k1, k1+k2, k2] per axis."""
    w = p["w"].to(x.dtype)                                          # (co, ci, 3, 3)
    rows = torch.stack([w[:, :, 0], w[:, :, 0] + w[:, :, 1],
                        w[:, :, 1] + w[:, :, 2], w[:, :, 2]], dim=2)     # (co, ci, 4, 3)
    k4 = torch.stack([rows[..., 0], rows[..., 0] + rows[..., 1],
                      rows[..., 1] + rows[..., 2], rows[..., 2]], dim=3)  # (co, ci, 4, 4)
    # lhs-dilated conv with k4 == transposed conv with the flipped kernel
    wt = k4.flip(2, 3).transpose(0, 1)
    o = F.conv_transpose2d(x, wt, None, stride=2, padding=1)
    return o + p["b"].to(x.dtype)[:, None, None]


def _spatial_resample(p, x, mode):
    y, bt = _frames_to_batch(x)
    if mode.startswith("upsample"):
        y = _upsample2x_conv3x3_subpixel(y, p["conv"])
    else:
        # ZeroPad2d(0, 1, 0, 1) + stride-2 conv
        y = _conv2d(F.pad(y, (0, 1, 0, 1)), p["conv"], stride=2)
    return _batch_to_frames(y, bt)


def _double_frames(y):
    """(B, 2C, T, H, W) -> (B, C, 2T, H, W): channel halves become the
    even and odd frames."""
    b, c2, t, h, w = y.shape
    c = c2 // 2
    return y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)


def resample38(p, x, mode, cache: CacheBank):
    """Resample38: downsample3d = spatial then stride-2 time conv (first
    frame passes through); upsample3d = causal time conv + frame doubling
    (first frame untouched) then spatial."""
    if mode == "upsample3d":
        if not cache.streaming:
            head, tail = x[:, :, :1], x[:, :, 1:]
            if tail.shape[2] > 0:
                y = causal_conv3d(p["time_conv"], tail, cache, t_pad=1)
                x = torch.cat([head, _double_frames(y)], dim=2)
            else:
                x = head
        elif cache.mode == "init":
            cache.push(x.new_zeros(x.shape[:2] + (2,) + x.shape[3:]))
        else:
            eff = torch.cat([cache.pull(), x], dim=2)
            cache.push(eff[:, :, -2:])
            x = _double_frames(_conv3d(eff, p["time_conv"]))
        return _spatial_resample(p, x, mode)

    x = _spatial_resample(p, x, mode)
    if mode == "downsample3d":
        if not cache.streaming:
            # a clip shorter than the time kernel (a single first frame)
            # keeps only its pass-through head frame
            if x.shape[2] >= p["time_conv"]["w"].shape[2]:
                x = torch.cat([x[:, :, :1], _conv3d(x, p["time_conv"], stride_t=2)], dim=2)
            else:
                x = x[:, :, :1]
        elif cache.mode == "init":
            cache.push(x[:, :, -1:])
        else:
            eff = torch.cat([cache.pull(), x], dim=2)
            cache.push(x[:, :, -1:])
            x = _conv3d(eff, p["time_conv"], stride_t=2)
    return x


def avg_down3d(x, out_channels, factor_t, factor_s):
    """AvgDown3D: front-pad time to the factor, fold (ft, fs, fs) into
    channels, average channel groups."""
    b, c, t, h, w = x.shape
    pad_t = (-t) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    ft, fs = factor_t, factor_s
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, c * ft * fs * fs, t // ft, h // fs, w // fs)
    group = c * ft * fs * fs // out_channels
    return x.reshape(b, out_channels, group, t // ft, h // fs, w // fs).mean(2)


def dup_up3d(x, out_channels, factor_t, factor_s, first_chunk):
    """DupUp3D: repeat channels, unfold them into (ft, fs, fs) offsets of
    the (t, h, w) grid."""
    b, c, t, h, w = x.shape
    ft, fs = factor_t, factor_s
    repeats = out_channels * ft * fs * fs // c
    y = x.repeat_interleave(repeats, dim=1)
    y = y.reshape(b, out_channels, ft, fs, fs, t, h, w)
    y = y.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, out_channels, t * ft, h * fs, w * fs)
    if first_chunk:
        y = y[:, :, ft - 1:]
    return y


# ------------------------------------------------------------------ networks
def encoder38_forward(p, cfg: WanVAEConfig, x, cache: CacheBank):
    """Encoder3d_38 (upstream wan_video_vae.py:620-733)."""
    x = causal_conv3d(p["conv1"], x, cache, t_pad=1, spatial_pad=1)
    dims = cfg.enc_dims
    for i in range(len(cfg.dim_mult)):
        stage = p["down"][i]
        t_down = cfg.temperal_downsample[i] if i < len(cfg.temperal_downsample) else False
        down_flag = i != len(cfg.dim_mult) - 1
        x_copy = x
        for blk in stage["blocks"]:
            x = residual_block(blk, x, cache)
        if down_flag:
            x = resample38(stage["resample"], x,
                           "downsample3d" if t_down else "downsample2d", cache)
        x = x + avg_down3d(x_copy, dims[i + 1], factor_t=2 if t_down else 1,
                           factor_s=2 if down_flag else 1)
    x = residual_block(p["middle"]["res1"], x, cache)
    x = attention_block(p["middle"]["attn"], x)
    x = residual_block(p["middle"]["res2"], x, cache)
    x = _norm_silu(p["head"]["norm"], x)
    return causal_conv3d(p["head"]["conv"], x, cache, t_pad=1, spatial_pad=1)


def decoder38_forward(p, cfg: WanVAEConfig, x, cache: CacheBank, first_chunk: bool = True):
    """Decoder3d_38 (upstream wan_video_vae.py:842-940)."""
    dims = cfg.dec_dims
    x = causal_conv3d(p["conv1"], x, cache, t_pad=1, spatial_pad=1)
    x = residual_block(p["middle"]["res1"], x, cache)
    x = attention_block(p["middle"]["attn"], x)
    x = residual_block(p["middle"]["res2"], x, cache)
    for i in range(len(cfg.dim_mult)):
        stage = p["up"][i]
        t_up = cfg.temperal_upsample[i] if i < len(cfg.temperal_upsample) else False
        x_main = x
        for blk in stage["blocks"]:
            x_main = residual_block(blk, x_main, cache)
        if i != len(cfg.dim_mult) - 1:
            x_main = resample38(stage["resample"], x_main,
                                "upsample3d" if t_up else "upsample2d", cache)
            x = x_main + dup_up3d(x, dims[i + 1], factor_t=2 if t_up else 1,
                                  factor_s=2, first_chunk=first_chunk)
        else:
            x = x_main
    x = _norm_silu(p["head"]["norm"], x)
    return causal_conv3d(p["head"]["conv"], x, cache, t_pad=1, spatial_pad=1)


def encoder_v1_forward(p, cfg: WanVAEConfig, x, cache: CacheBank):
    """Encoder3d (Wan2.1, upstream wan_video_vae.py:517-617): residual
    stacks and resamples, no averaging shortcuts."""
    x = causal_conv3d(p["conv1"], x, cache, t_pad=1, spatial_pad=1)
    for i, stage in enumerate(p["down"]):
        for blk in stage["blocks"]:
            x = residual_block(blk, x, cache)
        if "resample" in stage:
            t_down = cfg.temperal_downsample[i] if i < len(cfg.temperal_downsample) else False
            x = resample38(stage["resample"], x,
                           "downsample3d" if t_down else "downsample2d", cache)
    x = residual_block(p["middle"]["res1"], x, cache)
    x = attention_block(p["middle"]["attn"], x)
    x = residual_block(p["middle"]["res2"], x, cache)
    x = _norm_silu(p["head"]["norm"], x)
    return causal_conv3d(p["head"]["conv"], x, cache, t_pad=1, spatial_pad=1)


def decoder_v1_forward(p, cfg: WanVAEConfig, x, cache: CacheBank, first_chunk: bool = True):
    """Decoder3d (Wan2.1, upstream wan_video_vae.py:736-838): the spatial
    upsample's conv halves the channels; no duplicating shortcuts, so the
    first chunk needs no rule of its own (``first_chunk`` is unused)."""
    x = causal_conv3d(p["conv1"], x, cache, t_pad=1, spatial_pad=1)
    x = residual_block(p["middle"]["res1"], x, cache)
    x = attention_block(p["middle"]["attn"], x)
    x = residual_block(p["middle"]["res2"], x, cache)
    for i, stage in enumerate(p["up"]):
        for blk in stage["blocks"]:
            x = residual_block(blk, x, cache)
        if "resample" in stage:
            t_up = cfg.temperal_upsample[i] if i < len(cfg.temperal_upsample) else False
            x = resample38(stage["resample"], x, "upsample3d" if t_up else "upsample2d", cache)
    x = _norm_silu(p["head"]["norm"], x)
    return causal_conv3d(p["head"]["conv"], x, cache, t_pad=1, spatial_pad=1)


def _encoder(cfg: WanVAEConfig):
    return encoder38_forward if cfg.arch == "38" else encoder_v1_forward


def _decoder(cfg: WanVAEConfig):
    return decoder38_forward if cfg.arch == "38" else decoder_v1_forward


# ------------------------------------------------------------ patchify helpers
def pixel_patchify(x, patch):
    """(B, C, T, H, W) -> (B, C·p·p, T, H/p, W/p), channel order (c, r, q)
    ('b c f (h q) (w r) -> b (c r q) f h w')."""
    b, c, t, hh, ww = x.shape
    h, w = hh // patch, ww // patch
    y = x.reshape(b, c, t, h, patch, w, patch)
    return y.permute(0, 1, 6, 4, 2, 3, 5).reshape(b, c * patch * patch, t, h, w)


def pixel_unpatchify(x, patch, out_channels=3):
    b, _, t, h, w = x.shape
    y = x.reshape(b, out_channels, patch, patch, t, h, w)   # (b, c, r, q, t, h, w)
    return y.permute(0, 1, 4, 5, 3, 6, 2).reshape(b, out_channels, t, h * patch, w * patch)


# ---------------------------------------------------------------- public API
def _chunk_fns(which: str):
    """The first-chunk and steady-chunk functions of the streamed encoder
    (``which="enc"``) or decoder: ``first(params, cfg, xc) -> (y, entries)``
    runs in ``CacheBank("init")``, ``step(params, cfg, xc, entries) -> (y,
    entries)`` in ``CacheBank("step", entries)``."""

    def fwd(params, cfg, xc, bank, first):
        if which == "enc":
            return _encoder(cfg)(params["encoder"], cfg, xc, bank)
        return _decoder(cfg)(params["decoder"], cfg, xc, bank, first_chunk=first)

    def first_fn(params, cfg, xc):
        bank = CacheBank("init")
        return fwd(params, cfg, xc, bank, True), bank.out

    def step_fn(params, cfg, xc, entries):
        bank = CacheBank("step", list(entries))
        return fwd(params, cfg, xc, bank, False), bank.out

    return first_fn, step_fn


def vae38_encode_core(params, cfg: WanVAEConfig, x, streaming: bool = False):
    """Patchified pixels (B, 3·p², T, H, W) -> normalized latent mu.
    Streamed: a 1-frame first chunk, then 4-frame chunks; as in the JAX
    package, frames past the last whole chunk of 4 are not encoded."""
    if not streaming:
        out = _encoder(cfg)(params["encoder"], cfg, x, CacheBank("full"))
    else:
        t = x.shape[2]
        chunks = [x[:, :, :1]] + [x[:, :, 1 + 4 * i: 1 + 4 * (i + 1)]
                                  for i in range((t - 1) // 4)]
        first_fn, step_fn = _chunk_fns("enc")
        y, entries = first_fn(params, cfg, chunks[0])
        outs = [y]
        for c in chunks[1:]:
            y, entries = step_fn(params, cfg, c, entries)
            outs.append(y)
        out = torch.cat(outs, dim=2)
    out = causal_conv3d(params["conv1"], out, CacheBank("full"), t_pad=0)
    mu = out[:, : cfg.z_dim]
    shape = (1, -1, 1, 1, 1)
    mean = params["latent_mean"].to(mu.dtype).reshape(shape)
    inv_std = (1.0 / params["latent_std"]).to(mu.dtype).reshape(shape)
    return (mu - mean) * inv_std


def vae38_decode_core(params, cfg: WanVAEConfig, z, streaming: bool = False,
                      frames_per_chunk: int = 1):
    """Normalized latents (B, z, T', h, w) -> patchified pixels.  Streamed:
    latent frame 0 alone, then ``frames_per_chunk`` frames a chunk (the
    conv caches carry across chunks of any length)."""
    shape = (1, -1, 1, 1, 1)
    z = (z * params["latent_std"].to(z.dtype).reshape(shape)
         + params["latent_mean"].to(z.dtype).reshape(shape))
    x = causal_conv3d(params["conv2"], z, CacheBank("full"), t_pad=0)
    if not streaming:
        return _decoder(cfg)(params["decoder"], cfg, x, CacheBank("full"))
    first_fn, step_fn = _chunk_fns("dec")
    y, entries = first_fn(params, cfg, x[:, :, :1])
    outs = [y]
    k = max(1, int(frames_per_chunk))
    for i in range(1, x.shape[2], k):
        y, entries = step_fn(params, cfg, x[:, :, i: i + k], entries)
        outs.append(y)
    return torch.cat(outs, dim=2)


def vae38_encode(params, cfg: WanVAEConfig, video, streaming: bool = False):
    """video (B, C, T, H, W) in [-1, 1] -> normalized latents
    (B, z, (T-1)/4+1, H/f, W/f), f = ``cfg.upsampling_factor`` (16 for the
    VAE38, 8 for the Wan2.1 VAE)."""
    return vae38_encode_core(params, cfg, pixel_patchify(video, cfg.patch_size), streaming)


def vae38_decode(params, cfg: WanVAEConfig, latents, streaming: bool = False,
                 clamp: bool = True, frames_per_chunk: int = 1):
    """latents (B, z, T', h, w) -> video (B, C, T, H, W) in [-1, 1]."""
    x = vae38_decode_core(params, cfg, latents, streaming, frames_per_chunk=frames_per_chunk)
    video = pixel_unpatchify(x, cfg.patch_size, cfg.in_channels)
    return video.clamp(-1, 1) if clamp else video


# ------------------------------------------------------------------ converter
def convert_vae38_state_dict(sd, cfg: WanVAEConfig, dtype=None, device="cuda"):
    """Upstream VideoVAE38_ state dict of numpy arrays (optionally
    'model.'-prefixed) -> port params on ``device``; conv weights keep the
    checkpoint's (C_out, C_in, k...) layout."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def conv(prefix):
        return {"w": np.asarray(sd[prefix + ".weight"]), "b": np.asarray(sd[prefix + ".bias"])}

    def gamma(prefix):
        return np.asarray(sd[prefix + ".gamma"]).reshape(-1)

    def res(prefix, has_shortcut):
        p = {"norm1": gamma(prefix + ".residual.0"), "conv1": conv(prefix + ".residual.2"),
             "norm2": gamma(prefix + ".residual.3"), "conv2": conv(prefix + ".residual.6")}
        if has_shortcut:
            p["shortcut"] = conv(prefix + ".shortcut")
        return p

    def attn(prefix):
        return {"norm": gamma(prefix + ".norm"), "qkv": conv(prefix + ".to_qkv"),
                "proj": conv(prefix + ".proj")}

    def stages(root, dims, n_res, temporal):
        out = []
        for i in range(len(cfg.dim_mult)):
            pre = f"{root}.{i}.{root.split('.')[-1]}"
            blocks, in_dim = [], dims[i]
            for j in range(n_res):
                blocks.append(res(f"{pre}.{j}", in_dim != dims[i + 1]))
                in_dim = dims[i + 1]
            stage = {"blocks": blocks}
            if i != len(cfg.dim_mult) - 1:
                stage["resample"] = {"conv": conv(f"{pre}.{n_res}.resample.1")}
                if temporal[i]:
                    stage["resample"]["time_conv"] = conv(f"{pre}.{n_res}.time_conv")
            out.append(stage)
        return out

    def middle(root):
        return {"res1": res(root + ".0", False), "attn": attn(root + ".1"),
                "res2": res(root + ".2", False)}

    params = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "down": stages("encoder.downsamples", cfg.enc_dims, cfg.num_res_blocks,
                           cfg.temperal_downsample),
            "middle": middle("encoder.middle"),
            "head": {"norm": gamma("encoder.head.0"), "conv": conv("encoder.head.2")},
        },
        "conv1": conv("conv1"),
        "conv2": conv("conv2"),
        "decoder": {
            "conv1": conv("decoder.conv1"),
            "middle": middle("decoder.middle"),
            "up": stages("decoder.upsamples", cfg.dec_dims, cfg.num_res_blocks + 1,
                         cfg.temperal_upsample),
            "head": {"norm": gamma("decoder.head.0"), "conv": conv("decoder.head.2")},
        },
        "latent_mean": VAE38_MEAN[: cfg.z_dim].copy(),
        "latent_std": VAE38_STD[: cfg.z_dim].copy(),
    }
    return to_tensors(params, device, dtype)


def convert_vae_v1_state_dict(sd, cfg: WanVAEConfig, dtype=None, device="cuda"):
    """Upstream VideoVAE_ (Wan2.1) state dict of numpy arrays (optionally
    'model.'-prefixed) -> port params on ``device``.  Encoder3d / Decoder3d
    number their residual blocks and resamples in one flat nn.Sequential
    (upstream wan_video_vae.py:543-558, 767-783); the decoder's spatial
    upsample halves the channels, so each later stage's first block takes
    dims[i] // 2 (":770-771")."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def conv(prefix):
        return {"w": np.asarray(sd[prefix + ".weight"]), "b": np.asarray(sd[prefix + ".bias"])}

    def gamma(prefix):
        return np.asarray(sd[prefix + ".gamma"]).reshape(-1)

    def res(prefix, has_shortcut):
        p = {"norm1": gamma(prefix + ".residual.0"), "conv1": conv(prefix + ".residual.2"),
             "norm2": gamma(prefix + ".residual.3"), "conv2": conv(prefix + ".residual.6")}
        if has_shortcut:
            p["shortcut"] = conv(prefix + ".shortcut")
        return p

    def attn(prefix):
        return {"norm": gamma(prefix + ".norm"), "qkv": conv(prefix + ".to_qkv"),
                "proj": conv(prefix + ".proj")}

    def stages(root, dims, n_res, temporal, halved):
        out, idx = [], 0
        for i in range(len(cfg.dim_mult)):
            in_dim = dims[i] // 2 if halved and i > 0 else dims[i]
            blocks = []
            for _ in range(n_res):
                blocks.append(res(f"{root}.{idx}", in_dim != dims[i + 1]))
                in_dim, idx = dims[i + 1], idx + 1
            stage = {"blocks": blocks}
            if i != len(cfg.dim_mult) - 1:
                stage["resample"] = {"conv": conv(f"{root}.{idx}.resample.1")}
                if i < len(temporal) and temporal[i]:
                    stage["resample"]["time_conv"] = conv(f"{root}.{idx}.time_conv")
                idx += 1
            out.append(stage)
        return out

    def middle(root):
        return {"res1": res(root + ".0", False), "attn": attn(root + ".1"),
                "res2": res(root + ".2", False)}

    mean, std = latent_stats(cfg)
    params = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "down": stages("encoder.downsamples", cfg.enc_dims, cfg.num_res_blocks,
                           cfg.temperal_downsample, False),
            "middle": middle("encoder.middle"),
            "head": {"norm": gamma("encoder.head.0"), "conv": conv("encoder.head.2")},
        },
        "conv1": conv("conv1"),
        "conv2": conv("conv2"),
        "decoder": {
            "conv1": conv("decoder.conv1"),
            "middle": middle("decoder.middle"),
            "up": stages("decoder.upsamples", cfg.dec_dims, cfg.num_res_blocks + 1,
                         cfg.temperal_upsample, True),
            "head": {"norm": gamma("decoder.head.0"), "conv": conv("decoder.head.2")},
        },
        "latent_mean": mean,
        "latent_std": std,
    }
    return to_tensors(params, device, dtype)
