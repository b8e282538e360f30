"""The Wan-Animate adapter (port of fairygen_tpu/models/wan/animate.py;
upstream ``wan_video_animate_adapter.py``).

* The pose branch: a Conv3d patch embedding of the pose video's latents
  (a dense over (c, kt, kh, kw) patches) added to the DiT's patch tokens of
  frames 1.. (frame 0 is the reference frame's).
* The face branch: a StyleGAN appearance encoder (equalized convs, the
  [1, 3, 3, 1] blur before each stride-2 conv, fused leaky ReLU) and its
  motion MLP give 20 coordinates a face, projected on the QR-orthonormal
  direction basis (the QR in fp32) to a 512-wide motion vector; a causal
  conv1d encoder turns the per-frame vectors into (heads + 1) motion tokens
  a latent frame, and a face block after every ``adapter_stride``-th DiT
  block adds a per-frame cross-attention of the DiT tokens over them.

Layouts follow ``convert.from_jax_params``: conv2d weights channels-first
(C_out, C_in, kh, kw), conv1d weights (k, C_in, C_out), dense (d_in,
d_out).  The face block's attention over heads + 1 tokens is a plain
einsum softmax, as in the JAX package (no kernel there either).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors
from ...ops.norms import layer_norm, rms_norm
from .dit import _dense
from .s2v import _causal_conv1d, _ln_silu


@dataclasses.dataclass(frozen=True)
class AnimateConfig:
    hidden_dim: int = 5120
    heads_num: int = 40
    num_adapter_layers: int = 8  # 40 // 5
    adapter_stride: int = 5
    face_in_dim: int = 512
    face_heads: int = 4
    face_inner: int = 1024  # the face encoder's channel width
    motion_size: int = 512
    style_dim: int = 512
    motion_dim: int = 20
    pose_in_dim: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)


# the appearance encoder's channels at each resolution (upstream EncoderApp)
APP_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32}


# --------------------------------------------------- equalized StyleGAN ops
def _equal_conv2d(p, x, stride=1, padding=0):
    """EqualConv2d: NCHW x, weight (C_out, C_in, kh, kw) times 1/sqrt(fan_in)."""
    w = p["w"]
    scale = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
    y = F.conv2d(x, (w * scale).to(x.dtype), stride=stride, padding=padding)
    if "b" in p:
        y = y + p["b"].to(x.dtype)[:, None, None]
    return y


def _equal_linear(p, x, lr_mul=1.0):
    w = p["w"]  # (in, out)
    scale = (1.0 / math.sqrt(w.shape[0])) * lr_mul
    y = torch.matmul(x, (w * scale).to(x.dtype))
    if "b" in p:
        y = y + (p["b"] * lr_mul).to(x.dtype)
    return y


def _fused_leaky_relu(x, bias, negative_slope=0.2, scale=2 ** 0.5):
    y = x + bias.to(x.dtype)[:, None, None]
    return torch.where(y >= 0, y, negative_slope * y) * scale


def _blur(x, pad, kernel_1d=(1, 3, 3, 1)):
    """The normalized outer-product kernel as a depthwise conv (symmetric,
    so correlation is convolution), ``pad`` = (before, after) on H and W."""
    k = np.asarray(kernel_1d, np.float32)
    k2 = np.outer(k, k)
    k2 = k2 / k2.sum()
    c = x.shape[1]
    w = torch.from_numpy(np.ascontiguousarray(np.tile(k2[None, None], (c, 1, 1, 1))))
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, w.to(x.device, x.dtype), groups=c)


def _conv_layer(p, x, kernel_size, downsample=False, activate=True):
    if downsample:
        factor, blur_len = 2, 4
        pp = (blur_len - factor) + (kernel_size - 1)
        x = _blur(x, ((pp + 1) // 2, pp // 2))
        x = _equal_conv2d(p["conv"], x, stride=2, padding=0)
    else:
        x = _equal_conv2d(p["conv"], x, stride=1, padding=kernel_size // 2)
    if activate:
        x = _fused_leaky_relu(x, p["act_bias"])
    return x


def _res_block(p, x):
    out = _conv_layer(p["conv1"], x, 3)
    out = _conv_layer(p["conv2"], out, 3, downsample=True)
    skip = _conv_layer(p["skip"], x, 1, downsample=True, activate=False)
    return (out + skip) / math.sqrt(2)


def encoder_app_forward(p, x):
    """The appearance encoder: images (B, 3, S, S) -> codes (B, 512)."""
    h = _conv_layer(p["convs"][0], x, 1)
    for blk in p["res_blocks"]:
        h = _res_block(blk, h)
    h = _equal_conv2d(p["final"], h, stride=1, padding=0)
    return h[:, :, 0, 0]


def get_motion(params, x):
    """Faces (B, 3, S, S) -> motion vectors (B, 512): the appearance code
    through the motion MLP, then onto the QR-orthonormal direction basis
    (QR of the fp32 weight + 1e-8)."""
    h = encoder_app_forward(params["net_app"], x)
    for fc in params["fc"]:
        h = _equal_linear(fc, h)
    q, _ = torch.linalg.qr(params["direction_weight"].float() + 1e-8)
    return torch.matmul(h.float(), q.T).to(x.dtype)


# ---------------------------------------------------------------- face path
def face_encoder_forward(p, cfg: AnimateConfig, x):
    """(B, T, 512) motion vectors -> (B, T', heads + 1, D) motion tokens."""
    b = x.shape[0]
    y = _causal_conv1d(p["conv1_local"], x)
    t = y.shape[1]
    y = y.reshape(b, t, cfg.face_heads, cfg.face_inner).transpose(1, 2)
    y = _ln_silu(y.reshape(b * cfg.face_heads, t, cfg.face_inner))
    y = _ln_silu(_causal_conv1d(p["conv2"], y, stride=2))
    y = _ln_silu(_causal_conv1d(p["conv3"], y, stride=2))
    y = _dense(p["out_proj"], y)
    tl = y.shape[1]
    y = y.reshape(b, cfg.face_heads, tl, -1).transpose(1, 2)
    pad = p["padding_tokens"].to(y.dtype).expand(b, tl, 1, y.shape[-1])
    return torch.cat([y, pad], dim=-2)


def face_block_forward(p, cfg: AnimateConfig, x, motion_vec):
    """The face block's residual: each latent frame's DiT tokens (B, S, D)
    attend over that frame's motion tokens (B, T, N, D)."""
    B, T, N, C = motion_vec.shape
    H = cfg.heads_num
    hd = C // H
    kv = _dense(p["linear1_kv"], layer_norm(motion_vec, 1e-6)).reshape(B, T, N, 2, H, hd)
    q = _dense(p["linear1_q"], layer_norm(x, 1e-6))
    S = q.shape[1]
    q = rms_norm(q.reshape(B, S, H, hd), p["q_norm"], 1e-6)
    k = rms_norm(kv[..., 0, :, :], p["k_norm"], 1e-6)
    q = q.reshape(B * T, S // T, H, hd)
    k = k.reshape(B * T, N, H, hd)
    v = kv[..., 1, :, :].reshape(B * T, N, H, hd)
    logits = torch.einsum("bsnd,btnd->bnst", q, k).float() * (hd ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bnst,btnd->bsnd", probs, v).reshape(B, S, H * hd)
    return _dense(p["linear2"], o)


# ------------------------------------------------------------- adapter API
def animate_after_patch_embedding(params, cfg: AnimateConfig, x, grid, pose_latents,
                                  face_pixel_values):
    """The DiT's patch tokens x (B, f·h·w, D) over ``grid`` (f, h, w): the
    pose latents' patch embedding added to frames 1.., and the face video
    (B, 3, T, S, S) -> motion tokens with a zero leading frame.  Returns
    (x, motion_vec (B, T' + 1, heads + 1, D))."""
    B, C, T, H, W = pose_latents.shape
    pt, ph, pw = cfg.patch_size
    f, h, w = T // pt, H // ph, W // pw
    v = pose_latents.reshape(B, C, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    pe = _dense(params["pose_patch_embedding"], v.reshape(B, f * h * w, C * pt * ph * pw))
    per = grid[1] * grid[2]
    x = torch.cat([x[:, :per], x[:, per:] + pe.to(x.dtype)], dim=1)

    b, c, tf, hh, ww = face_pixel_values.shape
    faces = face_pixel_values.transpose(1, 2).reshape(b * tf, c, hh, ww)
    motion = get_motion(params["motion_encoder"], faces).reshape(b, tf, -1)
    motion_vec = face_encoder_forward(params["face_encoder"], cfg, motion)
    pad = motion_vec.new_zeros((motion_vec.shape[0], 1) + motion_vec.shape[2:])
    return x, torch.cat([pad, motion_vec], dim=1)


def animate_after_transformer_block(params, cfg: AnimateConfig, block_idx, x, motion_vec):
    """After every ``adapter_stride``-th block: x plus its face block's
    residual."""
    if block_idx % cfg.adapter_stride != 0:
        return x
    p = params["face_adapter"][block_idx // cfg.adapter_stride]
    return x + face_block_forward(p, cfg, x, motion_vec)


# ------------------------------------------------------------------ converter
def convert_animate_state_dict(sd: Dict[str, np.ndarray], cfg: AnimateConfig, dtype=None,
                               device="cuda"):
    """Upstream Animate adapter state dict (motion_encoder.*,
    face_encoder.*, face_adapter.fuser_blocks.N.*, pose_patch_embedding)
    -> port params on ``device``."""
    def g(name):
        return np.asarray(sd[name])

    def lw(name):
        p = {"w": g(name + ".weight").T}
        if name + ".bias" in sd:
            p["b"] = g(name + ".bias")
        return p

    def conv1d(name):
        return {"w": g(name + ".weight").transpose(2, 1, 0), "b": g(name + ".bias")}

    def conv_layer(prefix, downsample, activate=True):
        # nn.Sequential: [Blur]? EqualConv2d, [FusedLeakyReLU]
        idx = 1 if downsample else 0
        p = {"conv": {"w": g(f"{prefix}.{idx}.weight")}}
        if f"{prefix}.{idx}.bias" in sd:
            p["conv"]["b"] = g(f"{prefix}.{idx}.bias")
        if activate:
            p["act_bias"] = g(f"{prefix}.{idx + 1}.bias").reshape(-1)
        return p

    me = "motion_encoder.enc.net_app"
    res_blocks = []
    i = 1
    while f"{me}.convs.{i}.conv1.0.weight" in sd:
        res_blocks.append({"conv1": conv_layer(f"{me}.convs.{i}.conv1", False),
                           "conv2": conv_layer(f"{me}.convs.{i}.conv2", True),
                           "skip": conv_layer(f"{me}.convs.{i}.skip", True, activate=False)})
        i += 1
    fc = []
    j = 0
    while f"motion_encoder.enc.fc.{j}.weight" in sd:
        fc.append({"w": g(f"motion_encoder.enc.fc.{j}.weight").T,
                   "b": g(f"motion_encoder.enc.fc.{j}.bias")})
        j += 1
    blocks = []
    k = 0
    while f"face_adapter.fuser_blocks.{k}.linear1_q.weight" in sd:
        pre = f"face_adapter.fuser_blocks.{k}"
        blocks.append({"linear1_kv": lw(pre + ".linear1_kv"), "linear1_q": lw(pre + ".linear1_q"),
                       "linear2": lw(pre + ".linear2"), "q_norm": g(pre + ".q_norm.weight"),
                       "k_norm": g(pre + ".k_norm.weight")})
        k += 1
    pe = g("pose_patch_embedding.weight")  # (D, C, pt, ph, pw)
    params = {
        "pose_patch_embedding": {"w": pe.transpose(1, 2, 3, 4, 0).reshape(-1, pe.shape[0]),
                                 "b": g("pose_patch_embedding.bias")},
        "motion_encoder": {
            "net_app": {"convs": [conv_layer(f"{me}.convs.0", False)], "res_blocks": res_blocks,
                        "final": {"w": g(f"{me}.convs.{i}.weight")}},
            "fc": fc, "direction_weight": g("motion_encoder.dec.direction.weight")},
        "face_encoder": {"conv1_local": conv1d("face_encoder.conv1_local.conv"),
                         "conv2": conv1d("face_encoder.conv2.conv"),
                         "conv3": conv1d("face_encoder.conv3.conv"),
                         "out_proj": lw("face_encoder.out_proj"),
                         "padding_tokens": g("face_encoder.padding_tokens")},
        "face_adapter": blocks,
    }
    return to_tensors(params, device, dtype)
