"""Auxiliary Wan conditioning models: the motion controller and the VACE
branch (port of fairygen_tpu/models/wan/aux_models.py).

* The motion controller (upstream ``wan_video_motion_controller.py``):
  sinusoid(bucket·10) -> a 3-layer SiLU MLP -> a 6-way additive bias on the
  DiT's block modulation (``wan_dit_forward(t_mod_bias=...)``).

* VACE (upstream ``wan_video_vace.py``): DiT blocks over the patchified
  control video, the first fed ``before_proj(c) + x``; each emits an
  ``after_proj`` hint that the main DiT adds after its mapped block
  (x += hint·scale).  The JAX package stacks the hints into an
  (L_main, B, S, D) array, zero off the mapped blocks; the port keeps only
  the mapped hints, {block index: (B, S, D)}, which gives the same sums
  without the zeros (3.2 GB at 14B and S = 7800).

The VACE blocks run ``dit_block`` as the JAX package does
(``aux_models.py:107``): the fused norms (K1), and no full-width RoPE
tables, so q / k take the plain rms -> RoPE chain into the bounded
attention (K3 / K4 on the card) and the text cross-attention is q's rms
into K4, with each block's text (k, v) projected from the embedded prompt.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import linear, to_tensors
from ...ops.norms import rms_norm
from .dit import (IMAGE_TOKENS, WanDiTConfig, _dense, dit_block, sinusoidal_embedding_1d)


# ----------------------------------------------------------- motion controller
@dataclasses.dataclass(frozen=True)
class MotionControllerConfig:
    freq_dim: int = 256
    dim: int = 1536


def motion_controller_forward(params, cfg: MotionControllerConfig, motion_bucket_id):
    """motion_bucket_id (B,) fp32 -> t_mod bias (B, 6, dim)."""
    emb = sinusoidal_embedding_1d(cfg.freq_dim, motion_bucket_id * 10.0)
    emb = emb.to(params["fc1"]["w"].dtype)
    h = F.silu(_dense(params["fc1"], emb).float()).to(emb.dtype)
    h = F.silu(_dense(params["fc2"], h).float()).to(emb.dtype)
    out = _dense(params["fc3"], h)
    return out.reshape(out.shape[0], 6, cfg.dim)


def convert_motion_controller_state_dict(sd, cfg: MotionControllerConfig, dtype=None,
                                         device="cuda"):
    """Upstream state dict (linear.0 / .2 / .4) -> port params on ``device``."""
    params = {"fc1": linear(sd, "linear.0"), "fc2": linear(sd, "linear.2"),
              "fc3": linear(sd, "linear.4")}
    return to_tensors(params, device, dtype)


# --------------------------------------------------------------------- VACE
@dataclasses.dataclass(frozen=True)
class VaceConfig:
    vace_layers: Tuple[int, ...] = tuple(range(0, 30, 2))
    vace_in_dim: int = 96
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    has_image_input: bool = False
    dim: int = 1536
    num_heads: int = 12
    ffn_dim: int = 8960
    eps: float = 1e-6

    def dit_cfg(self) -> WanDiTConfig:
        return WanDiTConfig(
            dim=self.dim, in_dim=self.vace_in_dim, ffn_dim=self.ffn_dim,
            out_dim=self.vace_in_dim, text_dim=4096, freq_dim=256, eps=self.eps,
            patch_size=self.patch_size, num_heads=self.num_heads,
            num_layers=len(self.vace_layers), has_image_input=self.has_image_input)


def _image_kv(ca, img, cfg: WanDiTConfig):
    b, li, _ = img.shape
    k = rms_norm(_dense(ca["k_img"], img), ca["norm_k_img"], cfg.eps)
    v = _dense(ca["v_img"], img)
    return (k.reshape(b, li, cfg.num_heads, cfg.head_dim),
            v.reshape(b, li, cfg.num_heads, cfg.head_dim))


def vace_forward(params, cfg: VaceConfig, x_tokens, vace_context, context_emb, t_mod, freqs,
                 seg=None) -> Dict[int, torch.Tensor]:
    """The hints {main block index: (B, S, D)} of the VACE branch.

    x_tokens: the main DiT's patch tokens (B, S, D); vace_context (B, C, F,
    H, W), patchified and zero-padded to S tokens; context_emb the embedded
    prompt ([257 image tokens, text] for an image-input branch); t_mod and
    freqs the main DiT's."""
    dcfg = cfg.dit_cfg()
    b, s, d = x_tokens.shape
    pt, ph, pw = cfg.patch_size
    B, C, F_, H, W = vace_context.shape
    f, h, w = F_ // pt, H // ph, W // pw
    v = vace_context.reshape(B, C, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    c = _dense(params["patch_embedding"], v.reshape(B, f * h * w, C * pt * ph * pw))
    if c.shape[1] < s:
        c = torch.cat([c, c.new_zeros((B, s - c.shape[1], d))], dim=1)
    ctx = context_emb
    img = None
    if cfg.has_image_input:
        img, ctx = context_emb[:, :IMAGE_TOKENS], context_emb[:, IMAGE_TOKENS:]
    hints = {}
    for i, blk in enumerate(params["blocks"]):
        if i == 0:
            c = _dense(blk["before_proj"], c) + x_tokens
        img_kv = None if img is None else _image_kv(blk["cross_attn"], img, dcfg)
        c = dit_block(blk, c, t_mod, freqs, None, dcfg, None, seg, img_kv, ctx)
        hints[cfg.vace_layers[i]] = _dense(blk["after_proj"], c)
    return hints


def convert_vace_state_dict(sd, cfg: VaceConfig, dtype=None, device="cuda"):
    """Upstream VACE state dict (vace_patch_embedding, vace_blocks.N.*) ->
    port params on ``device``."""
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
    blocks = []
    for n in range(len(cfg.vace_layers)):
        pre = f"vace_blocks.{n}"
        blk = {"self_attn": attn(pre + ".self_attn"),
               "cross_attn": attn(pre + ".cross_attn", cfg.has_image_input),
               "norm3": {"w": g(pre + ".norm3.weight"), "b": g(pre + ".norm3.bias")},
               "ffn": {"fc1": linear(sd, pre + ".ffn.0"), "fc2": linear(sd, pre + ".ffn.2")},
               "modulation": g(pre + ".modulation").reshape(6, D),
               "after_proj": linear(sd, pre + ".after_proj")}
        if n == 0:
            blk["before_proj"] = linear(sd, pre + ".before_proj")
        blocks.append(blk)
    pe = g("vace_patch_embedding.weight")  # (D, C, pt, ph, pw)
    params = {"patch_embedding": {"w": pe.transpose(1, 2, 3, 4, 0).reshape(-1, D),
                                  "b": g("vace_patch_embedding.bias")},
              "blocks": blocks}
    return to_tensors(params, device, dtype)
