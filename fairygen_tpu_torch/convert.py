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

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.wan.dit import WanDiTConfig
from .models.wan.text_encoder import UMT5Config
from .models.wan.vae import VAE38_MEAN, VAE38_STD, WanVAEConfig


def _leaf(a, key, device, dtype):
    t = torch.as_tensor(np.array(a))
    if key == "w" and t.dim() == 5:
        t = t.permute(4, 3, 0, 1, 2)
    elif key == "w" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.contiguous().to(device)


def _tree(node, device, dtype, key=None):
    if isinstance(node, dict):
        # LoRA leaves stay in their own dtype (fp32), whatever the base's
        out = {k: _tree(v, device, None if k == "lora" else dtype, k) for k, v in node.items()}
        if isinstance(node.get("blocks"), dict):  # stacked DiT blocks -> list
            stacked = out["blocks"]
            n = len(next(iter(_leaves(stacked))))
            out["blocks"] = [_index(stacked, i) for i in range(n)]
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


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i].contiguous()


def from_jax_params(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """A JAX-package param tree (numpy leaves) of the Wan DiT, UMT5 or
    VAE38 -> port state on ``device`` (optionally cast to ``dtype``; LoRA
    subtrees keep their dtype)."""
    return _tree(tree, resolve_device(device), dtype)


# ------------------------------------------------------------------ init
class _Init:
    def __init__(self, device, dtype, generator):
        self.device, self.dtype, self.g = device, dtype, generator

    def normal(self, shape, std):
        t = torch.randn(shape, generator=self.g, device=self.device, dtype=self.dtype)
        return t.mul_(std)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def dense(self, d_in, d_out, bias=True):
        p = {"w": self.normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = self.zeros((d_out,))
        return p


def _generator(device, seed):
    return torch.Generator(device).manual_seed(int(seed))


def init_dit_params(cfg: WanDiTConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random DiT params at the JAX package's ``init_dit_params`` scales:
    dense N(0, 1/d_in), zero biases, modulation N(0, 1/D), unit norms."""
    device = resolve_device(device)
    r = _Init(device, dtype, _generator(device, seed))
    D = cfg.dim
    pt, ph, pw = cfg.patch_size

    def attn():
        return {"q": r.dense(D, D), "k": r.dense(D, D), "v": r.dense(D, D), "o": r.dense(D, D),
                "norm_q": r.ones((D,)), "norm_k": r.ones((D,))}

    return {
        "patch_embed": r.dense(cfg.in_dim * pt * ph * pw, D),
        "text_embed": {"fc1": r.dense(cfg.text_dim, D), "fc2": r.dense(D, D)},
        "time_embed": {"fc1": r.dense(cfg.freq_dim, D), "fc2": r.dense(D, D)},
        "time_proj": r.dense(D, 6 * D),
        "head": {**r.dense(D, cfg.out_dim * pt * ph * pw),
                 "modulation": r.normal((2, D), D ** -0.5)},
        "blocks": [
            {"self_attn": attn(), "cross_attn": attn(),
             "norm3": {"w": r.ones((D,)), "b": r.zeros((D,))},
             "ffn": {"fc1": r.dense(D, cfg.ffn_dim), "fc2": r.dense(cfg.ffn_dim, D)},
             "modulation": r.normal((6, D), D ** -0.5)}
            for _ in range(cfg.num_layers)
        ],
    }


def init_umt5_params(cfg: UMT5Config, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random UMT5 params: N(0, 1) token embedding and relative-position
    tables, bias-free dense N(0, 1/d_in), unit norms."""
    device = resolve_device(device)
    r = _Init(device, dtype, _generator(device, seed))
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
    """Random VAE38 params in the tree of the JAX package's
    ``init_vae_params``, unit norm gammas and zero biases as there, but
    conv weights N(0, 1/fan_in) instead of zeros, so that encode and
    decode carry signal through every layer."""
    device = resolve_device(device)
    r = _Init(device, dtype, _generator(device, seed))

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
    up = []
    for i in range(nm):
        blocks = [res(dec[i] if j == 0 else dec[i + 1], dec[i + 1])
                  for j in range(cfg.num_res_blocks + 1)]
        stage = {"blocks": blocks}
        if i != nm - 1:
            stage["resample"] = {"conv": conv(dec[i + 1], dec[i + 1], 3, 3)}
            if cfg.temperal_upsample[i]:
                stage["resample"]["time_conv"] = conv(2 * dec[i + 1], dec[i + 1], 3, 1, 1)
        up.append(stage)
    z2, cin = 2 * cfg.z_dim, cfg.conv_in_channels
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
        "latent_mean": torch.from_numpy(VAE38_MEAN[: cfg.z_dim]).to(device, dtype),
        "latent_std": torch.from_numpy(VAE38_STD[: cfg.z_dim]).to(device, dtype),
    }


def count_params(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))
