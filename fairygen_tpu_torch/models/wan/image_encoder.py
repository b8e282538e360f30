"""Wan CLIP image encoder: the open-CLIP ViT-H/14 visual tower of the I2V
models' CLIP branch (port of fairygen_tpu/models/wan/image_encoder.py).

``encode_image`` resizes to 224 x 224 as ``jax.image.resize(...,
"cubic")`` does (Keys cubic, a = -0.5, antialiased along an axis that
shrinks), maps [-1, 1] to CLIP's normalisation and runs the ViT through all
but its last block (``use_31_block``), returning (B, 257, 1280) features
for the DiT's ``img_emb`` MLP.  As in the JAX package, the tower runs in
the images' dtype (fp32; the weights are cast to it) and its attention is a
plain product with an fp32 softmax: its head dim is 80, which no kernel of
the port takes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import Init, generator, linear, to_tensors
from ...device import resolve_device

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    activation: str = "gelu"
    norm_eps: float = 1e-5

    @staticmethod
    def vit_h_14() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny(**over) -> "ViTConfig":
        base = dict(image_size=28, patch_size=14, dim=32, num_heads=4, num_layers=3)
        base.update(over)
        return ViTConfig(**base)


def _ln(p, x, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def _dense(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def _act(x, kind):
    xf = x.float()
    y = xf * torch.sigmoid(1.702 * xf) if kind == "quick_gelu" else F.gelu(xf)
    return y.to(x.dtype)


def vit_forward(params, cfg: ViTConfig, images, use_31_block: bool = True):
    """images (B, 3, H, W) CLIP-normalized -> tokens (B, 1 + P², dim), in
    the images' dtype."""
    b, c, hh, ww = images.shape
    p = cfg.patch_size
    # channel-first patch order (c, kh, kw), the torch Conv2d's flatten
    x = images.reshape(b, c, hh // p, p, ww // p, p).permute(0, 2, 4, 1, 3, 5)
    x = _dense(params["patch_embedding"], x.reshape(b, (hh // p) * (ww // p), c * p * p))
    cls = params["cls_embedding"].to(x.dtype).expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"].to(x.dtype)
    if "pre_norm" in params:
        x = _ln(params["pre_norm"], x, cfg.norm_eps)
    n_blocks = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    n, hd = cfg.num_heads, cfg.dim // cfg.num_heads
    for blk in params["blocks"][:n_blocks]:
        h = _ln(blk["norm1"], x, cfg.norm_eps)
        q, k, v = _dense(blk["to_qkv"], h).split(cfg.dim, dim=-1)
        L = q.shape[1]
        q, k, v = (t.reshape(b, L, n, hd).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
        probs = torch.softmax(logits, -1).to(x.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, L, cfg.dim)
        x = x + _dense(blk["proj"], o)
        h = _ln(blk["norm2"], x, cfg.norm_eps)
        x = x + _dense(blk["fc2"], _act(_dense(blk["fc1"], h), cfg.activation))
    if not use_31_block:
        x = _ln(params["post_norm"], x, cfg.norm_eps)
    return x


@functools.lru_cache(maxsize=None)
def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 weights of ``jax.image.resize``'s Keys cubic
    resampling of one axis (``jax.image.scale_and_translate``'s
    ``compute_weight_mat``: half-pixel sample points, the kernel widened by
    n_in / n_out when the axis shrinks, columns normalised to sum to 1),
    computed in fp32 as there."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    w = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def bicubic_resize(images, size: int):
    """(B, C, H, W) -> (B, C, size, size) as ``jax.image.resize(...,
    method="cubic")``: the separable weights of :func:`cubic_resize_weights`
    applied as two products (rows, then columns), in the images' dtype.
    ``F.interpolate``'s bicubic differs (a = -0.75, no antialias)."""
    h, w = images.shape[-2:]
    wh = torch.from_numpy(cubic_resize_weights(h, size)).to(images.device, images.dtype)
    ww = torch.from_numpy(cubic_resize_weights(w, size)).to(images.device, images.dtype)
    y = torch.matmul(images.transpose(-1, -2), wh).transpose(-1, -2)  # (B, C, size, W)
    return torch.matmul(y, ww)


def encode_image(params, cfg: ViTConfig, images_pm1):
    """images (B, 3, H, W) in [-1, 1] -> (B, 257, dim) in fp32 (upstream
    encode_image: bicubic resize, ·0.5 + 0.5, CLIP normalisation, the
    visual tower through 31 of its 32 blocks)."""
    x = bicubic_resize(images_pm1.float(), cfg.image_size) * 0.5 + 0.5
    mean = torch.from_numpy(CLIP_MEAN).to(x.device).reshape(1, 3, 1, 1)
    std = torch.from_numpy(CLIP_STD).to(x.device).reshape(1, 3, 1, 1)
    return vit_forward(params, cfg, (x - mean) / std, use_31_block=True)


def convert_vit_state_dict(sd: Dict[str, np.ndarray], cfg: ViTConfig, dtype=None,
                           prefix: str = "", device="cuda"):
    """Upstream VisionTransformer state dict of numpy arrays (optionally
    'model.visual.'-prefixed, as in WanImageEncoder checkpoints) -> port
    params on ``device``; dense weights (in, out)."""
    if prefix == "" and any(k.startswith("model.visual.") for k in sd):
        prefix = "model.visual."
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def g(name):
        return np.asarray(sd[name])

    def norm(name):
        return {"w": g(name + ".weight"), "b": g(name + ".bias")}

    pe = g("patch_embedding.weight")  # (D, 3, p, p)
    params: Dict[str, Any] = {
        "patch_embedding": {"w": pe.transpose(1, 2, 3, 0).reshape(-1, cfg.dim)},
        "cls_embedding": g("cls_embedding").reshape(1, 1, cfg.dim),
        "pos_embedding": g("pos_embedding"),
    }
    if "patch_embedding.bias" in sd:
        params["patch_embedding"]["b"] = g("patch_embedding.bias")
    for name in ("pre_norm", "post_norm"):
        if name + ".weight" in sd:
            params[name] = norm(name)
    params["blocks"] = [
        {"norm1": norm(f"transformer.{i}.norm1"),
         "to_qkv": linear(sd, f"transformer.{i}.attn.to_qkv"),
         "proj": linear(sd, f"transformer.{i}.attn.proj"),
         "norm2": norm(f"transformer.{i}.norm2"),
         "fc1": linear(sd, f"transformer.{i}.mlp.0"),
         "fc2": linear(sd, f"transformer.{i}.mlp.2")}
        for i in range(cfg.num_layers)]
    return to_tensors(params, device, dtype)


def init_vit_params(cfg: ViTConfig, device="cuda", dtype=torch.bfloat16, seed=0):
    """Random ViT params in the converter's tree: N(0, 1/d_in) dense
    weights with zero biases, N(0, dim^-1/2) class and position embeddings,
    unit LayerNorms (a bias-free patch embedding with pre- and post-norm,
    as open-CLIP's ViT-H/14)."""
    device = resolve_device(device)
    r = Init(device, dtype, generator(device, seed))
    d, f, p = cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.patch_size

    def norm():
        return {"w": r.ones((d,)), "b": r.zeros((d,))}

    tokens = 1 + (cfg.image_size // p) ** 2
    return {
        "patch_embedding": {"w": r.normal((3 * p * p, d), (3 * p * p) ** -0.5)},
        "cls_embedding": r.normal((1, 1, d), d ** -0.5),
        "pos_embedding": r.normal((1, tokens, d), d ** -0.5),
        "pre_norm": norm(), "post_norm": norm(),
        "blocks": [{"norm1": norm(), "to_qkv": r.dense(d, 3 * d), "proj": r.dense(d, d),
                    "norm2": norm(), "fc1": r.dense(d, f), "fc2": r.dense(f, d)}
                   for _ in range(cfg.num_layers)],
    }
