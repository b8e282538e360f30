"""AutoencoderKL, the SD / SDXL / FLUX.1 image VAE (port of
fairygen_tpu/models/sdxl/vae.py).

Channels-first (B, C, H, W) inside, conv weights (C_out, C_in, kh, kw); the
public ``vae_encode``/``vae_decode`` keep the JAX package's interface and
its unscaled latents (callers apply the (shift, scale) normalization).
Encoder and decoder of time-embedding-free resnets with one mid-block
attention; that attention is a plain product in the JAX package too, so it
stays plain PyTorch here, as do the convolutions and the GroupNorm.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors
from ..wan.vae import _upsample2x_conv3x3_subpixel


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    shift_factor: float = 0.0  # FLUX: z = (mean - shift) * scale
    use_quant_conv: bool = True  # the FLUX VAE has no quant/post_quant convs

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def sdxl() -> "AutoencoderKLConfig":
        """The SDXL VAE (sdxl-vae / sdxl-vae-fp16-fix), scaling factor 0.13025."""
        return AutoencoderKLConfig()

    @staticmethod
    def flux() -> "AutoencoderKLConfig":
        """The FLUX.1 16-channel VAE."""
        return AutoencoderKLConfig(latent_channels=16, scaling_factor=0.3611,
                                   shift_factor=0.1159, use_quant_conv=False)

    @staticmethod
    def tiny(**over) -> "AutoencoderKLConfig":
        base = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
        base.update(over)
        return AutoencoderKLConfig(**base)


def group_norm(x, p, num_groups=32, eps=1e-5):
    """GroupNorm over (B, C, ...) in fp32, then ·w + b, cast back."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (y * p["w"].float().reshape(shape) + p["b"].float().reshape(shape)).to(x.dtype)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def _conv(p, x, stride=1, padding=1):
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=padding)


def _resnet(p, x, groups, eps=1e-6):
    h = _conv(p["conv1"], _silu(group_norm(x, p["norm1"], groups, eps)))
    h = _conv(p["conv2"], _silu(group_norm(h, p["norm2"], groups, eps)))
    if "conv_shortcut" in p:
        x = _conv(p["conv_shortcut"], x, padding=0)
    return x + h


def _attn(p, x, groups, eps=1e-6):
    b, c, h, w = x.shape
    y = group_norm(x, p["group_norm"], groups, eps).reshape(b, c, h * w).transpose(1, 2)

    def d(name, v):
        return v @ p[name]["w"].to(v.dtype) + p[name]["b"].to(v.dtype)

    q, k, v = d("to_q", y), d("to_k", y), d("to_v", y)
    logits = torch.einsum("bsc,btc->bst", q, k).float() * (c ** -0.5)
    probs = torch.softmax(logits, -1).to(x.dtype)
    o = d("to_out", torch.einsum("bst,btc->bsc", probs, v))
    return x + o.transpose(1, 2).reshape(b, c, h, w)


def _mid(p, x, g):
    return _resnet(p["res2"], _attn(p["attn"], _resnet(p["res1"], x, g), g), g)


def vae_encode(params, cfg: AutoencoderKLConfig, images, sample_mode: str = "mode",
               generator=None):
    """(B, 3, H, W) in [-1, 1] -> latents (B, C_lat, H/f, W/f), UNSCALED
    (the mean, or a draw from ``generator`` with ``sample_mode="sample"``)."""
    p, g = params["encoder"], cfg.norm_num_groups
    x = _conv(p["conv_in"], images)
    for stage in p["down_blocks"]:
        for r in stage["resnets"]:
            x = _resnet(r, x, g)
        if "downsamplers" in stage:  # pad (0, 1, 0, 1), stride-2 conv
            x = _conv(stage["downsamplers"], F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = _mid(p["mid"], x, g)
    x = _conv(p["conv_out"], _silu(group_norm(x, p["conv_norm_out"], g)))
    if cfg.use_quant_conv:
        x = _conv(params["quant_conv"], x, padding=0)
    mean, logvar = x.chunk(2, dim=1)
    if sample_mode == "sample":
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=torch.float32)
        mean = mean + std * noise.to(mean.dtype)
    return mean


def vae_decode(params, cfg: AutoencoderKLConfig, latents):
    """UNSCALED latents (B, C_lat, h, w) -> images (B, 3, H, W)."""
    x = latents
    if cfg.use_quant_conv:
        x = _conv(params["post_quant_conv"], x, padding=0)
    p, g = params["decoder"], cfg.norm_num_groups
    x = _mid(p["mid"], _conv(p["conv_in"], x), g)
    for stage in p["up_blocks"]:
        for r in stage["resnets"]:
            x = _resnet(r, x, g)
        if "upsamplers" in stage:  # conv3x3 of the nearest 2x upsample
            x = _upsample2x_conv3x3_subpixel(x, stage["upsamplers"])
    return _conv(p["conv_out"], _silu(group_norm(x, p["conv_norm_out"], g)))


# ------------------------------------------------------------------ converters
def weight_bias(sd, name):
    """A conv (weights kept (C_out, C_in, kh, kw)) or a norm's affine."""
    return {"w": np.asarray(sd[name + ".weight"]), "b": np.asarray(sd[name + ".bias"])}


def attn_linear(sd, name):
    """An attention projection; old checkpoints store it as a 1x1 conv."""
    w = np.asarray(sd[name + ".weight"])
    return {"w": (w[:, :, 0, 0] if w.ndim == 4 else w).T, "b": np.asarray(sd[name + ".bias"])}


def resnet_weights(sd, pre, shortcut="conv_shortcut"):
    p = {"norm1": weight_bias(sd, pre + ".norm1"), "conv1": weight_bias(sd, pre + ".conv1"),
         "norm2": weight_bias(sd, pre + ".norm2"), "conv2": weight_bias(sd, pre + ".conv2")}
    if f"{pre}.{shortcut}.weight" in sd:
        p["conv_shortcut"] = weight_bias(sd, f"{pre}.{shortcut}")
    return p


def convert_autoencoder_kl_state_dict(sd, cfg: AutoencoderKLConfig, dtype=None, device="cuda"):
    """diffusers AutoencoderKL state dict (numpy) -> port params on
    ``device``."""
    def attn(pre):
        return {"group_norm": weight_bias(sd, pre + ".group_norm"),
                "to_q": attn_linear(sd, pre + ".to_q"), "to_k": attn_linear(sd, pre + ".to_k"),
                "to_v": attn_linear(sd, pre + ".to_v"),
                "to_out": attn_linear(sd, pre + ".to_out.0")}

    def stages(root, n_res, sampler):
        out = []
        for i in range(len(cfg.block_out_channels)):
            pre = f"{root}.{i}"
            st = {"resnets": [resnet_weights(sd, f"{pre}.resnets.{j}") for j in range(n_res)]}
            if f"{pre}.{sampler}.0.conv.weight" in sd:
                st[sampler] = weight_bias(sd, f"{pre}.{sampler}.0.conv")
            out.append(st)
        return out

    def mid(pre):
        return {"res1": resnet_weights(sd, pre + ".resnets.0"),
                "attn": attn(pre + ".attentions.0"),
                "res2": resnet_weights(sd, pre + ".resnets.1")}

    params = {
        "encoder": {
            "conv_in": weight_bias(sd, "encoder.conv_in"),
            "down_blocks": stages("encoder.down_blocks", cfg.layers_per_block, "downsamplers"),
            "mid": mid("encoder.mid_block"),
            "conv_norm_out": weight_bias(sd, "encoder.conv_norm_out"),
            "conv_out": weight_bias(sd, "encoder.conv_out"),
        },
        "quant_conv": weight_bias(sd, "quant_conv"),
        "post_quant_conv": weight_bias(sd, "post_quant_conv"),
        "decoder": {
            "conv_in": weight_bias(sd, "decoder.conv_in"),
            "mid": mid("decoder.mid_block"),
            "up_blocks": stages("decoder.up_blocks", cfg.layers_per_block + 1, "upsamplers"),
            "conv_norm_out": weight_bias(sd, "decoder.conv_norm_out"),
            "conv_out": weight_bias(sd, "decoder.conv_out"),
        },
    }
    return to_tensors(params, device, dtype)
