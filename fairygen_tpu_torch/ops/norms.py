"""Normalization / modulation primitives (fp32 internals), plain PyTorch.

Port of fairygen_tpu/ops/norms.py; same op order and casts.
"""
from __future__ import annotations

import torch


def rms_norm(x, weight, eps=1e-5):
    """x·rsqrt(mean(x²)+eps) in fp32, cast back to x.dtype, then ·weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


def t5_layer_norm(x, weight, eps=1e-6):
    """T5: no mean subtraction; fp32 rsqrt; cast to weight dtype then scale."""
    xf = x.float()
    y = x * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    if weight.dtype in (torch.float16, torch.bfloat16):
        y = y.to(weight.dtype)
    return weight * y


def layer_norm(x, eps=1e-6, weight=None, bias=None):
    """LayerNorm in fp32 (elementwise_affine optional)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def modulate(x, shift, scale):
    return x * (1 + scale) + shift
