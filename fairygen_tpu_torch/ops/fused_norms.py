"""K1: LayerNorm -> two-segment AdaLN modulate (port of
fairygen_tpu/ops/fused_norms.py ``layer_norm_modulate`` / ``_ln_mod_kernel``).

CUDA tensors go through the hand-written kernel ``csrc/ln_modulate.cu``
(bf16); CPU tensors take :func:`layer_norm_modulate_plain`, the same
formula in PyTorch.  The gradient differentiates the plain formula, as the
JAX package's ``_ln_mod_bwd`` does: there is no backward kernel.
"""
from __future__ import annotations

import torch

from . import _kernels


def layer_norm_modulate_plain(x, shift2, scale2, seg: int = 0, eps: float = 1e-6):
    """Plain version of K1 (the JAX package's ``_ln_mod_reference``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    second = (torch.arange(x.shape[1], device=x.device) >= seg)[None, :, None]
    sc = torch.where(second, scale2[:, 1:2], scale2[:, 0:1]).float()
    sh = torch.where(second, shift2[:, 1:2], shift2[:, 0:1]).float()
    return (y * (1.0 + sc) + sh).to(x.dtype)


def layer_norm_modulate(x, shift2, scale2, seg: int = 0, eps: float = 1e-6):
    """x (B, S, D); shift2/scale2 (B, 2, D) segment rows; tokens with index
    >= ``seg`` use row 1 (``seg=0`` => row 1 everywhere)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, shift2, scale2)):
        return _LayerNormModulate.apply(x, shift2, scale2, seg, eps)
    if not x.is_cuda:
        return layer_norm_modulate_plain(x, shift2, scale2, seg, eps)
    b, s, d = x.shape
    for name, t, nd in (("x", x, 3), ("shift2", shift2, 3), ("scale2", scale2, 3)):
        _kernels.check_cuda(t, name, torch.bfloat16, nd)
    if shift2.shape != (b, 2, d) or scale2.shape != (b, 2, d):
        raise ValueError(f"shift2/scale2 must be {(b, 2, d)}, got "
                         f"{tuple(shift2.shape)} / {tuple(scale2.shape)}")
    if d % 8 or d > 4096:
        raise ValueError(f"ln_modulate kernel needs D % 8 == 0 and D <= 4096, got {d}")
    out = torch.empty_like(x)
    _kernels.launch("ln_modulate", "fg_ln_modulate", x.data_ptr(), shift2.data_ptr(),
                    scale2.data_ptr(), out.data_ptr(), b, s, d, int(seg), float(eps))
    return out


class _LayerNormModulate(torch.autograd.Function):
    """Forward K1 (through :func:`layer_norm_modulate`, grad off), backward
    the autograd of :func:`layer_norm_modulate_plain` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, shift2, scale2, seg, eps):
        ctx.save_for_backward(x, shift2, scale2)
        ctx.seg, ctx.eps = seg, eps
        return layer_norm_modulate(x, shift2, scale2, seg, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm_modulate_plain(*inputs, ctx.seg, ctx.eps)
        grads = torch.autograd.grad(out, inputs, g)
        return grads + (None, None)


def affine_rows(weight, bias, batch: int):
    """Affine LayerNorm (y*w + b) as modulation rows: scale = w - 1,
    shift = b, duplicated so both segments match.  Returns contiguous
    (batch, 2, D) rows."""
    sc = (weight - 1.0)[None, None].expand(batch, 2, weight.shape[0]).contiguous()
    sh = bias[None, None].expand(batch, 2, bias.shape[0]).contiguous()
    return sh, sc
