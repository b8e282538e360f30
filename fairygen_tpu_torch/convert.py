"""Params of the port: conversion from the JAX package's trees, and seeded
initialisation on a device.

Port state is a nested dict (and list) of tensors mirroring the JAX pytree,
with two layout rules: the DiT's stacked per-block leaves (leading axis L)
become a list of L block dicts (a stacked LoRA ``scale`` of shape (L,)
becomes one 0-d tensor per block), and convolution weights are channels-first
— 5-D ``w`` (kt, kh, kw, C_in, C_out) -> (C_out, C_in, kt, kh, kw), 4-D
``w`` (kh, kw, C_in, C_out) -> (C_out, C_in, kh, kw).  Dense weights stay
(d_in, d_out).

``init_*`` make full-width weights directly on the given device and dtype
from a ``torch.Generator`` — nothing of model size is built on the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .core.params import Init, generator
from .device import resolve_device
from .models.flux.dit import init_flux_dit_params  # noqa: F401  (the FLUX.1 DiT's init)
from .models.qwen.text_encoder import init_qwen_text_params  # noqa: F401  (Qwen3's init)
from .models.sdxl.unet2d import init_unet2d_params  # noqa: F401  (the SDXL UNet's and BrushNet's)
from .models.wan.image_encoder import init_vit_params  # noqa: F401  (the CLIP ViT-H's init)
from .models.z_image.dit import init_z_image_dit_params  # noqa: F401  (the Z-Image DiT's init)
from .models.sdxl.clip import CLIPTextConfig
from .models.sdxl.vae import AutoencoderKLConfig
from .models.wan.animate import APP_CHANNELS, AnimateConfig
from .models.wan.aux_models import MotionControllerConfig, VaceConfig
from .models.wan.camera import SimpleAdapterConfig
from .models.wan.dit import WanDiTConfig
from .models.wan.longcat import LongCatDiTConfig
from .models.wan.mot import MotConfig
from .models.wan.s2v import S2VConfig
from .models.wan.text_encoder import UMT5Config
from .models.wan.vae import WanVAEConfig, latent_stats
from .models.wan.wav2vec import Wav2Vec2Config
from .ops.quant import int_mm_layout


def _leaf(a, key, device, dtype):
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.as_tensor(a)
    if key == "w" and t.dim() == 5:
        t = t.permute(4, 3, 0, 1, 2)
    elif key == "w" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    t = t.contiguous().to(device)
    return int_mm_layout(t) if key == "w_int8" and t.dim() == 2 else t


_STACKED = ("blocks", "double_blocks", "single_blocks", "layers")
# leaves that keep their own dtype under ``dtype=``: LoRA subtrees (fp32)
# and a W8A8 layer's scales (fp32) and outlier operands (bf16)
_OWN_DTYPE = ("lora", "w_scale", "act_smooth", "outlier_sel", "w_outlier")


def _tree(node, device, dtype, key=None):
    if isinstance(node, dict):
        out = {k: _tree(v, device, None if k in _OWN_DTYPE else dtype, k)
               for k, v in node.items()}
        for key in _STACKED:  # stacked DiT blocks -> list
            if isinstance(node.get(key), dict):
                stacked = out[key]
                n = len(next(iter(_leaves(stacked))))
                out[key] = [_index(stacked, i) for i in range(n)]
        return out
    if isinstance(node, (list, tuple)):
        return [_tree(v, device, dtype, key) for v in node]
    return _leaf(node, key, device, dtype)


def _leaves(node):
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _index(node, i, key=None):
    if isinstance(node, dict):
        return {k: _index(v, i, k) for k, v in node.items()}
    return int_mm_layout(node[i]) if key == "w_int8" else node[i].contiguous()


def from_jax_params(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """A JAX-package param tree (numpy leaves) of the Wan DiT (with the I2V
    image branch), UMT5, VAE38 or the Wan2.1 VAE, the CLIP ViT-H, FLUX.1
    DiT, T5, CLIP text tower, AutoencoderKL, Z-Image DiT, Qwen3 text
    encoder, SDXL UNet or BrushNet (with their LoRA / DoRA adapters), or
    the four-level SD1.5 UNet or BrushNet (its plain mid attention where
    the tree has one), the Wan variants' models (the DiT's Fun-Reference
    ``ref_conv``, the camera SimpleAdapter, the motion controller, the
    VACE branch, the S2V DiT and wav2vec, whose conv1d weights keep their
    (k, in, out) layout; the Wan-Animate adapter, its conv1d weights alike;
    the VAP / MoT branch; the LongCat-Video DiT) -> port state on
    ``device``, optionally cast to ``dtype``.  LoRA
    subtrees keep their dtype, and so do the scales and outlier operands
    of W8A8 layers (``ops/quant.py``); their ``w_int8`` stays int8, laid
    out column-major."""
    return _tree(tree, resolve_device(device), dtype)


# ------------------------------------------------------------------ init
def init_dit_params(cfg: WanDiTConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random DiT params at the JAX package's ``init_dit_params`` scales:
    dense N(0, 1/d_in), zero biases, modulation N(0, 1/D), unit norms; for
    ``has_image_input`` the CLIP branch too (``img_emb`` over 1280-wide CLIP
    tokens, each block's k_img / v_img / norm_k_img; a zero ``pos`` of 514
    rows with ``has_image_pos_emb``)."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    D = cfg.dim
    pt, ph, pw = cfg.patch_size
    params = {
        "patch_embed": r.dense(cfg.in_dim * pt * ph * pw, D),
        "text_embed": {"fc1": r.dense(cfg.text_dim, D), "fc2": r.dense(D, D)},
        "time_embed": {"fc1": r.dense(cfg.freq_dim, D), "fc2": r.dense(D, D)},
        "time_proj": r.dense(D, 6 * D),
        "head": {**r.dense(D, cfg.out_dim * pt * ph * pw),
                 "modulation": r.normal((2, D), D ** -0.5)},
        "blocks": [_dit_block(r, D, cfg.ffn_dim, cfg.has_image_input)
                   for _ in range(cfg.num_layers)],
    }
    if cfg.has_image_input:
        params["img_emb"] = _img_emb(r, D)
        if cfg.has_image_pos_emb:
            params["img_emb"]["pos"] = r.zeros((1, 514, 1280))
    if cfg.has_ref_conv:  # over (16 latent channels, 2, 2) patches, as the JAX init
        params["ref_conv"] = r.dense(16 * 2 * 2, D)
    return params


def _img_emb(r, D):
    """The CLIP feature MLP over 1280-wide CLIP tokens."""
    return {"norm1": {"w": r.ones((1280,)), "b": r.zeros((1280,))},
            "fc1": r.dense(1280, 1280), "fc2": r.dense(1280, D),
            "norm2": {"w": r.ones((D,)), "b": r.zeros((D,))}}


def _dit_block(r, D, ffn_dim, img=False):
    """One DiT block's random params (the draws in ``init_dit_params``'
    order); ``img``: the CLIP branch's k_img / v_img / norm_k_img."""
    def attn(img=False):
        p = {"q": r.dense(D, D), "k": r.dense(D, D), "v": r.dense(D, D), "o": r.dense(D, D),
             "norm_q": r.ones((D,)), "norm_k": r.ones((D,))}
        if img:
            p.update(k_img=r.dense(D, D), v_img=r.dense(D, D), norm_k_img=r.ones((D,)))
        return p

    return {"self_attn": attn(), "cross_attn": attn(img),
            "norm3": {"w": r.ones((D,)), "b": r.zeros((D,))},
            "ffn": {"fc1": r.dense(D, ffn_dim), "fc2": r.dense(ffn_dim, D)},
            "modulation": r.normal((6, D), D ** -0.5)}


def init_simple_adapter_params(cfg: SimpleAdapterConfig, device="cuda", dtype=torch.bfloat16,
                               seed=0):
    """Random camera SimpleAdapter params: conv weights (out, in, kh, kw)
    N(0, 1/fan_in), zero biases."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    o, cin = cfg.out_dim, cfg.in_dim * 64
    kh, kw = cfg.kernel_size

    def conv(cout, cin_, k1, k2):
        return {"w": r.normal((cout, cin_, k1, k2), (cin_ * k1 * k2) ** -0.5),
                "b": r.zeros((cout,))}

    return {"conv": conv(o, cin, kh, kw),
            "blocks": [{"conv1": conv(o, o, 3, 3), "conv2": conv(o, o, 3, 3)}
                       for _ in range(cfg.num_residual_blocks)]}


def init_motion_controller_params(cfg: MotionControllerConfig, device="cuda",
                                  dtype=torch.bfloat16, seed=0):
    """Random motion controller params: dense N(0, 1/d_in), zero biases."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    return {"fc1": r.dense(cfg.freq_dim, cfg.dim), "fc2": r.dense(cfg.dim, cfg.dim),
            "fc3": r.dense(cfg.dim, 6 * cfg.dim)}


def init_vace_params(cfg: VaceConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random VACE branch params: the patch embedding, and one DiT block a
    VACE layer with its after_proj (and before_proj on the first), at the
    scales of ``init_dit_params``."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    D = cfg.dim
    pt, ph, pw = cfg.patch_size
    blocks = []
    for n in range(len(cfg.vace_layers)):
        blk = _dit_block(r, D, cfg.ffn_dim, cfg.has_image_input)
        blk["after_proj"] = r.dense(D, D)
        if n == 0:
            blk["before_proj"] = r.dense(D, D)
        blocks.append(blk)
    return {"patch_embedding": r.dense(cfg.vace_in_dim * pt * ph * pw, D), "blocks": blocks}


def init_animate_params(cfg: AnimateConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random Wan-Animate adapter params: the appearance encoder for
    ``motion_size`` faces over upstream's channel table (equalized conv and
    linear weights N(0, 1), as upstream draws them, zero activation
    biases), the motion MLP and direction basis, the face encoder (conv1d
    weights (k, in, out) N(0, 1/fan_in)), the face blocks and the pose
    patch embedding (dense N(0, 1/d_in), unit norms, zero biases)."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    D, hd, sd = cfg.hidden_dim, cfg.hidden_dim // cfg.heads_num, cfg.style_dim
    pt, ph, pw = cfg.patch_size

    def layer(cout, cin, k, act=True):
        p = {"conv": {"w": r.normal((cout, cin, k, k), 1.0)}}
        if act:
            p["act_bias"] = r.zeros((cout,))
        return p

    def conv1d(cin, cout, k=3):
        return {"w": r.normal((k, cin, cout), (k * cin) ** -0.5), "b": r.zeros((cout,))}

    cin = APP_CHANNELS[cfg.motion_size]
    res_blocks = []
    for i in range(int(math.log2(cfg.motion_size)), 2, -1):
        cout = APP_CHANNELS[2 ** (i - 1)]
        res_blocks.append({"conv1": layer(cin, cin, 3), "conv2": layer(cout, cin, 3),
                           "skip": layer(cout, cin, 1, act=False)})
        cin = cout
    fc = [{"w": r.normal((sd, sd), 1.0), "b": r.zeros((sd,))} for _ in range(4)]
    fc.append({"w": r.normal((sd, cfg.motion_dim), 1.0), "b": r.zeros((cfg.motion_dim,))})
    inner = cfg.face_inner
    return {
        "pose_patch_embedding": r.dense(cfg.pose_in_dim * pt * ph * pw, D),
        "motion_encoder": {
            "net_app": {"convs": [layer(APP_CHANNELS[cfg.motion_size], 3, 1)],
                        "res_blocks": res_blocks, "final": {"w": r.normal((sd, cin, 4, 4), 1.0)}},
            "fc": fc, "direction_weight": r.normal((cfg.face_in_dim, cfg.motion_dim), 1.0)},
        "face_encoder": {"conv1_local": conv1d(cfg.face_in_dim, inner * cfg.face_heads),
                         "conv2": conv1d(inner, inner), "conv3": conv1d(inner, inner),
                         "out_proj": r.dense(inner, D), "padding_tokens": r.zeros((1, 1, 1, D))},
        "face_adapter": [{"linear1_kv": r.dense(D, 2 * D), "linear1_q": r.dense(D, D),
                          "linear2": r.dense(D, D), "q_norm": r.ones((hd,)),
                          "k_norm": r.ones((hd,))} for _ in range(cfg.num_adapter_layers)],
    }


def init_mot_params(cfg: MotConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random VAP / MoT branch params at ``init_dit_params``' scales: the
    patch, text and time embeddings, one DiT block a mapped layer (with the
    CLIP branch for ``has_image_input``) and the CLIP feature MLP."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    D = cfg.dim
    pt, ph, pw = cfg.patch_size
    params = {
        "patch_embedding": r.dense(cfg.in_dim * pt * ph * pw, D),
        "text_embed": {"fc1": r.dense(cfg.text_dim, D), "fc2": r.dense(D, D)},
        "time_embed": {"fc1": r.dense(cfg.freq_dim, D), "fc2": r.dense(D, D)},
        "time_proj": r.dense(D, 6 * D),
        "blocks": [_dit_block(r, D, cfg.ffn_dim, cfg.has_image_input) for _ in cfg.mot_layers],
    }
    if cfg.has_image_input:
        params["img_emb"] = _img_emb(r, D)
    return params


def init_longcat_params(cfg: LongCatDiTConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random LongCat-Video DiT params: dense N(0, 1/d_in) (the SwiGLU FFN
    without biases, as upstream), zero biases, unit norms."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    C, E, hd, f = cfg.hidden_size, cfg.adaln_tembed_dim, cfg.head_dim, cfg.ffn_hidden
    pt, ph, pw = cfg.patch_size

    def block():
        return {"adaln": r.dense(E, 6 * C), "qkv": r.dense(C, 3 * C), "q_norm": r.ones((hd,)),
                "k_norm": r.ones((hd,)), "proj": r.dense(C, C),
                "crs_norm": {"w": r.ones((C,)), "b": r.zeros((C,))}, "crs_q": r.dense(C, C),
                "crs_kv": r.dense(C, 2 * C), "crs_q_norm": r.ones((hd,)),
                "crs_k_norm": r.ones((hd,)), "crs_proj": r.dense(C, C),
                "w1": r.dense(C, f, False), "w2": r.dense(f, C, False),
                "w3": r.dense(C, f, False)}

    return {
        "x_embedder": r.dense(cfg.in_channels * pt * ph * pw, C),
        "t_mlp": {"fc1": r.dense(cfg.freq_dim, E), "fc2": r.dense(E, E)},
        "y_mlp": {"fc1": r.dense(cfg.caption_channels, C), "fc2": r.dense(C, C)},
        "blocks": [block() for _ in range(cfg.depth)],
        "final": {"adaln": r.dense(E, 2 * C),
                  "linear": r.dense(C, cfg.out_channels * pt * ph * pw)},
    }


def init_s2v_params(cfg: S2VConfig, device="cuda", dtype=torch.bfloat16, seed=0, blocks=None):
    """Random S2V DiT params at ``init_dit_params``' scales: the patch and
    pose embeddings, text / time MLPs, blocks (``blocks``: given ones, of
    the same shapes, to share), head, the condition embedding, the causal
    audio encoder (conv1d weights (k, in, out) N(0, 1/fan_in)), the audio
    injectors with AdaLN and the frame packer."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    D, a = cfg.dim, cfg.audio_dim
    pt, ph, pw = cfg.patch_size
    n_inject = len([layer for layer in cfg.audio_inject_layers if layer < cfg.num_layers])

    def conv1d(cin, cout, k=3):
        return {"w": r.normal((k, cin, cout), (k * cin) ** -0.5), "b": r.zeros((cout,))}

    def attn():
        return {"q": r.dense(D, D), "k": r.dense(D, D), "v": r.dense(D, D), "o": r.dense(D, D),
                "norm_q": r.ones((D,)), "norm_k": r.ones((D,))}

    enc = {"conv1_local": conv1d(a, D // 4 * cfg.num_audio_token),
           "conv2": conv1d(D // 4, D // 2), "conv3": conv1d(D // 2, D),
           "padding_tokens": r.zeros((1, 1, 1, D))}
    if cfg.enable_adain:
        enc.update(conv1_global=conv1d(a, D // 4), final_linear=r.dense(D, D))
    return {
        "patch_embedding": r.dense(cfg.in_dim * pt * ph * pw, D),
        "cond_encoder": r.dense(cfg.cond_dim * pt * ph * pw, D),
        "text_embed": {"fc1": r.dense(cfg.text_dim, D), "fc2": r.dense(D, D)},
        "time_embed": {"fc1": r.dense(cfg.freq_dim, D), "fc2": r.dense(D, D)},
        "time_proj": r.dense(D, 6 * D),
        "blocks": blocks if blocks is not None else [
            _dit_block(r, D, cfg.ffn_dim) for _ in range(cfg.num_layers)],
        "head": {**r.dense(D, cfg.out_dim * pt * ph * pw),
                 "modulation": r.normal((2, D), D ** -0.5)},
        "trainable_cond_mask": r.normal((3, D), 0.02),
        "casual_audio_encoder": {"weights": r.normal((1, cfg.num_audio_layers, 1, 1), 1.0),
                                 "encoder": enc},
        "audio_injector": {"injector": [attn() for _ in range(n_inject)],
                           "adain": [{"linear": r.dense(D, 2 * D)} for _ in range(n_inject)]
                           if cfg.enable_adain else []},
        "frame_packer": {"proj": r.dense(cfg.motion_channels * 4, D),
                         "proj_2x": r.dense(cfg.motion_channels * 2 * 4 * 4, D),
                         "proj_4x": r.dense(cfg.motion_channels * 4 * 8 * 8, D)},
    }


def init_wav2vec2_params(cfg: Wav2Vec2Config, device="cuda", seed=0):
    """Random fp32 wav2vec params in the converter's tree: conv weights (k,
    in, out) and dense N(0, 1/fan_in), unit LayerNorms, zero biases."""
    device = resolve_device(device)
    r = Init(device, torch.float32, generator(device, seed))

    def ln(d):
        return {"w": r.ones((d,)), "b": r.zeros((d,))}

    conv_layers, cin = [], 1
    for cout, k in zip(cfg.conv_dim, cfg.conv_kernel):
        p = {"conv": {"w": r.normal((k, cin, cout), (k * cin) ** -0.5)}, "ln": ln(cout)}
        if cfg.conv_bias:
            p["conv"]["b"] = r.zeros((cout,))
        conv_layers.append(p)
        cin = cout
    h, f, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_conv_pos_embeddings
    hg = h // cfg.num_conv_pos_embedding_groups
    return {
        "conv_layers": conv_layers, "fp_ln": ln(cfg.conv_dim[-1]),
        "fp_proj": r.dense(cfg.conv_dim[-1], h),
        "pos_conv": {"w": r.normal((k, hg, h), (k * hg) ** -0.5), "b": r.zeros((h,))},
        "layers": [{"ln1": ln(h), "q": r.dense(h, h), "k": r.dense(h, h), "v": r.dense(h, h),
                    "o": r.dense(h, h), "ln2": ln(h), "ffn1": r.dense(h, f),
                    "ffn2": r.dense(f, h)} for _ in range(cfg.num_hidden_layers)],
        "final_ln": ln(h),
    }


def init_umt5_params(cfg: UMT5Config, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random UMT5 params: N(0, 1) token embedding and relative-position
    tables, bias-free dense N(0, 1/d_in), unit norms."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    return {
        "token_embedding": r.normal((cfg.vocab, d), 1.0),
        "blocks": [
            {"norm1": r.ones((d,)), "norm2": r.ones((d,)),
             "attn": {"q": r.dense(d, da, False), "k": r.dense(d, da, False),
                      "v": r.dense(d, da, False), "o": r.dense(da, d, False)},
             "ffn": {"gate": r.dense(d, df, False), "fc1": r.dense(d, df, False),
                     "fc2": r.dense(df, d, False)},
             "pos_emb": r.normal((cfg.num_buckets, cfg.num_heads), 1.0)}
            for _ in range(cfg.num_layers)
        ],
        "norm": r.ones((d,)),
    }


def init_vae_params(cfg: WanVAEConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random VAE38 or Wan2.1 VAE (``cfg.arch``) params in the tree of the
    JAX package's ``init_vae_params``, unit norm gammas and zero biases as
    there, but conv weights N(0, 1/fan_in) instead of zeros, so that encode
    and decode carry signal through every layer."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))

    def conv(cout, cin, *k):
        fan_in = cin * int(np.prod(k))
        return {"w": r.normal((cout, cin) + k, fan_in ** -0.5), "b": r.zeros((cout,))}

    def res(cin, cout):
        p = {"norm1": r.ones((cin,)), "conv1": conv(cout, cin, 3, 3, 3),
             "norm2": r.ones((cout,)), "conv2": conv(cout, cout, 3, 3, 3)}
        if cin != cout:
            p["shortcut"] = conv(cout, cin, 1, 1, 1)
        return p

    def attn(c):
        return {"norm": r.ones((c,)), "qkv": conv(3 * c, c, 1, 1), "proj": conv(c, c, 1, 1)}

    enc, dec, nm = cfg.enc_dims, cfg.dec_dims, len(cfg.dim_mult)
    down = []
    for i in range(nm):
        blocks = [res(enc[i] if j == 0 else enc[i + 1], enc[i + 1])
                  for j in range(cfg.num_res_blocks)]
        stage = {"blocks": blocks}
        if i != nm - 1:
            stage["resample"] = {"conv": conv(enc[i + 1], enc[i + 1], 3, 3)}
            if cfg.temperal_downsample[i]:
                stage["resample"]["time_conv"] = conv(enc[i + 1], enc[i + 1], 3, 1, 1)
        down.append(stage)
    v1 = cfg.arch != "38"  # the Wan2.1 decoder's spatial upsample halves the channels
    up = []
    for i in range(nm):
        cin = dec[i] // 2 if v1 and i > 0 else dec[i]
        blocks = [res(cin if j == 0 else dec[i + 1], dec[i + 1])
                  for j in range(cfg.num_res_blocks + 1)]
        stage = {"blocks": blocks}
        if i != nm - 1:
            stage["resample"] = {"conv": conv(dec[i + 1] // 2 if v1 else dec[i + 1],
                                              dec[i + 1], 3, 3)}
            if cfg.temperal_upsample[i]:
                stage["resample"]["time_conv"] = conv(2 * dec[i + 1], dec[i + 1], 3, 1, 1)
        up.append(stage)
    z2, cin = 2 * cfg.z_dim, cfg.conv_in_channels
    mean, std = latent_stats(cfg)
    return {
        "encoder": {
            "conv1": conv(enc[0], cin, 3, 3, 3), "down": down,
            "middle": {"res1": res(enc[-1], enc[-1]), "attn": attn(enc[-1]),
                       "res2": res(enc[-1], enc[-1])},
            "head": {"norm": r.ones((enc[-1],)), "conv": conv(z2, enc[-1], 3, 3, 3)},
        },
        "conv1": conv(z2, z2, 1, 1, 1),
        "conv2": conv(cfg.z_dim, cfg.z_dim, 1, 1, 1),
        "decoder": {
            "conv1": conv(dec[0], cfg.z_dim, 3, 3, 3),
            "middle": {"res1": res(dec[0], dec[0]), "attn": attn(dec[0]),
                       "res2": res(dec[0], dec[0])},
            "up": up,
            "head": {"norm": r.ones((dec[-1],)), "conv": conv(cin, dec[-1], 3, 3, 3)},
        },
        "latent_mean": torch.from_numpy(mean).to(device, dtype),
        "latent_std": torch.from_numpy(std).to(device, dtype),
    }


def init_t5_params(cfg: UMT5Config, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random T5 v1.1 encoder params (one shared relative-position table):
    N(0, 1) token embedding and table, bias-free dense N(0, 1/d_in), unit
    norms.  ``UMT5Config.t5_v1_1_xxl()`` is FLUX.1's second text encoder."""
    if not cfg.shared_pos_bias:
        raise ValueError("init_t5_params is the shared-table T5 v1.1; use init_umt5_params")
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    return {
        "token_embedding": r.normal((cfg.vocab, d), 1.0),
        "pos_emb": r.normal((cfg.num_buckets, cfg.num_heads), 1.0),
        "blocks": [
            {"norm1": r.ones((d,)), "norm2": r.ones((d,)),
             "attn": {"q": r.dense(d, da, False), "k": r.dense(d, da, False),
                      "v": r.dense(d, da, False), "o": r.dense(da, d, False)},
             "ffn": {"gate": r.dense(d, df, False), "fc1": r.dense(d, df, False),
                     "fc2": r.dense(df, d, False)}}
            for _ in range(cfg.num_layers)
        ],
        "norm": r.ones((d,)),
    }


def init_clip_text_params(cfg: CLIPTextConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random CLIP text tower: N(0, 0.02) embeddings, dense N(0, 1/d_in)
    with zero biases, unit LayerNorms."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    c, f = cfg.hidden_size, cfg.intermediate_size

    def ln():
        return {"w": r.ones((c,)), "b": r.zeros((c,))}

    params = {
        "token_embedding": r.normal((cfg.vocab_size, c), 0.02),
        "position_embedding": r.normal((cfg.max_position_embeddings, c), 0.02),
        "layers": [{"ln1": ln(), "attn": {k: r.dense(c, c) for k in
                                          ("q_proj", "k_proj", "v_proj", "out_proj")},
                    "ln2": ln(), "fc1": r.dense(c, f), "fc2": r.dense(f, c)}
                   for _ in range(cfg.num_layers)],
        "final_layer_norm": ln(),
    }
    if cfg.projection_dim is not None:
        params["text_projection"] = r.normal((c, cfg.projection_dim), c ** -0.5)
    return params


def init_autoencoder_kl_params(cfg: AutoencoderKLConfig, device="cuda", dtype=torch.bfloat16,
                               seed=0):
    """Random AutoencoderKL params in the tree of the JAX package's
    ``init_autoencoder_kl_params`` (unit norm scales and zero biases as
    there), with conv and dense weights N(0, 1/fan_in) instead of zeros so
    that encode and decode carry signal through every layer."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))

    def conv(i, o, k=3):
        return {"w": r.normal((o, i, k, k), (i * k * k) ** -0.5), "b": r.zeros((o,))}

    def norm(c):
        return {"w": r.ones((c,)), "b": r.zeros((c,))}

    def resnet(i, o):
        p = {"norm1": norm(i), "conv1": conv(i, o), "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            p["conv_shortcut"] = conv(i, o, 1)
        return p

    def mid(c):
        return {"res1": resnet(c, c), "res2": resnet(c, c),
                "attn": {"group_norm": norm(c),
                         **{k: r.dense(c, c) for k in ("to_q", "to_k", "to_v", "to_out")}}}

    bo, lc, n_res = cfg.block_out_channels, cfg.latent_channels, cfg.layers_per_block
    downs, ch = [], bo[0]
    for i, out in enumerate(bo):
        st = {"resnets": [resnet(ch if j == 0 else out, out) for j in range(n_res)]}
        if i != len(bo) - 1:
            st["downsamplers"] = conv(out, out)
        downs.append(st)
        ch = out
    dec = list(reversed(bo))
    ups, ch = [], dec[0]
    for i, out in enumerate(dec):
        st = {"resnets": [resnet(ch if j == 0 else out, out) for j in range(n_res + 1)]}
        if i != len(dec) - 1:
            st["upsamplers"] = conv(out, out)
        ups.append(st)
        ch = out
    params = {
        "encoder": {"conv_in": conv(cfg.in_channels, bo[0]), "down_blocks": downs,
                    "mid": mid(bo[-1]), "conv_norm_out": norm(bo[-1]),
                    "conv_out": conv(bo[-1], 2 * lc)},
        "decoder": {"conv_in": conv(lc, dec[0]), "mid": mid(dec[0]), "up_blocks": ups,
                    "conv_norm_out": norm(dec[-1]), "conv_out": conv(dec[-1], cfg.out_channels)},
    }
    if cfg.use_quant_conv:
        params["quant_conv"] = conv(2 * lc, 2 * lc, 1)
        params["post_quant_conv"] = conv(lc, lc, 1)
    return params


def count_params(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))
