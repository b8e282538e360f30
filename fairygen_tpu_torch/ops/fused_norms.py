"""K1, K9, K11: the fused row norms (port of fairygen_tpu/ops/fused_norms.py).

* K1 (``_ln_mod_kernel``): LayerNorm -> two-segment AdaLN modulate,
  ``layer_norm_modulate``; :func:`ln_modulate` is the uniform one-row entry
  of the image DiTs over the same kernel.  ``csrc/ln_modulate.cu`` (bf16).
* K9 (``_rms_mod_kernel``): ``rms_norm(x, w)·scale``, the Z-Image sandwich
  norms, behind the JAX package's gate in :func:`rms_modulate`.
  ``csrc/rms_modulate.cu`` (bf16, fp32).
* K11 (``_vae_rms_silu_kernel``): the VAE channel RMS (F.normalize·√C·γ)
  with an optional SiLU, :func:`vae_rms_silu`.  No path of the JAX package
  calls it (its VAE38 keeps the plain norm and SiLU); here the VAE38's
  ``_norm_silu`` (``models/wan/vae.py``) runs :func:`fused_vae_rms_silu` on
  every encode and decode, output left channels-last.
  ``csrc/rms_modulate.cu`` (bf16, fp32).

CUDA tensors go through the hand-written kernels; CPU tensors take the
``*_plain`` versions, the same formulas in PyTorch.  Gradients
differentiate the plain formulas, as the JAX package's custom VJPs do:
there are no backward kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ln_modulate(x, shift, scale, eps: float = 1e-6):
    """Uniform AdaLN, ``layer_norm(x) * (1 + scale) + shift`` with one
    modulation row per sample, shift/scale (B, 1, D) or (B, D) (the FLUX.1
    form).  The JAX package's gate: D % 128 == 0 and S >= 256 go to K1 (the
    same row twice); anything else is the plain expression it runs off the
    kernel, which rounds the normalized x to x.dtype before modulating."""
    b, s, d = x.shape
    if d % 128 == 0 and s >= 256:
        sh = shift.reshape(shift.shape[0], 1, d).expand(b, 2, d).contiguous()
        sc = scale.reshape(scale.shape[0], 1, d).expand(b, 2, d).contiguous()
        return layer_norm_modulate(x, sh, sc, 0, eps)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * (1 + scale.reshape(-1, 1, d)) + shift.reshape(-1, 1, d)


# --------------------------------------------------------------------------
# K9 / K11 (port of ``_rms_mod_kernel`` and ``_vae_rms_silu_kernel``)

def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def rms_modulate_plain(x, weight, scale=None, eps: float = 1e-5):
    """Plain version of K9 (the JAX package's ``_rms_mod_reference``):
    x·rsqrt(mean(x²) + eps) in fp32, rounded to x.dtype, ·weight (rounded),
    ·scale (rounded).  scale (B, 1, D), (B, D) or None."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    out = y.to(x.dtype) * weight
    if scale is None:
        return out
    return out * scale.reshape(scale.shape[0], 1, x.shape[-1])


def fused_rms_modulate(x, weight, scale=None, eps: float = 1e-5):
    """K9: x (B, S, D); weight (D,) and scale (B|1, 1, D)/(B|1, D) or None,
    both cast to x.dtype as the Pallas wrapper casts them.  bf16 or fp32."""
    if _needs_grad(x, weight, scale):
        return _RmsModulate.apply(x, weight, scale, eps)
    if not x.is_cuda:
        return rms_modulate_plain(x, weight, scale, eps)
    b, s, d = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rms_modulate kernel takes bf16 or fp32, got {x.dtype}")
    vec = 16 // x.element_size()
    if d % vec or d > 512 * 4 * vec:
        raise ValueError(f"rms_modulate kernel needs D % {vec} == 0 and D <= {2048 * vec}, "
                         f"got {d}")
    _kernels.check_cuda(x, "x", x.dtype, 3)
    w = weight.to(x.dtype).contiguous()
    _kernels.check_cuda(w, "weight", x.dtype, 1)
    if w.shape[0] != d:
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    sc_ptr = 0
    if scale is not None:
        if scale.numel() not in (d, b * d):
            raise ValueError(f"scale must be (B|1, 1, {d}) or (B|1, {d}), got "
                             f"{tuple(scale.shape)}")
        sc = scale.reshape(-1, d).to(x.dtype).expand(b, d).contiguous()
        _kernels.check_cuda(sc, "scale", x.dtype, 2)
        sc_ptr = sc.data_ptr()
    out = torch.empty_like(x)
    _kernels.launch("rms_modulate", "fg_rms_modulate", x.data_ptr(), w.data_ptr(), sc_ptr,
                    out.data_ptr(), b, s, d, int(x.dtype == torch.float32), float(eps))
    return out


class _RmsModulate(torch.autograd.Function):
    """Forward K9 (through :func:`fused_rms_modulate`, grad off), backward
    the autograd of :func:`rms_modulate_plain` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, scale, eps):
        ctx.save_for_backward(x, weight, scale)
        ctx.eps = eps
        return fused_rms_modulate(x, weight, scale, eps)

    @staticmethod
    def backward(ctx, g):
        grads = _plain_grads(ctx, lambda x, w, sc: rms_modulate_plain(x, w, sc, ctx.eps), g)
        return grads + (None,)


def _plain_grads(ctx, plain, g):
    """Gradients of ``plain(*saved)`` for the saved tensors (None stays
    None)."""
    inputs = [None if t is None else t.detach().requires_grad_(True) for t in ctx.saved_tensors]
    with torch.enable_grad():
        out = plain(*inputs)
    wanted = [t for t in inputs if t is not None]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(None if t is None else next(grads) for t in inputs)


def rms_modulate(x, weight, scale=None, eps: float = 1e-5):
    """``rms_norm(x, weight, eps) * scale`` of the Z-Image sandwich norms:
    x (B, S, D), scale (B, 1, D)/(B, D) or None.  The JAX package's gate:
    D % 128 == 0 and S >= 256 go to K9, anything else to the plain
    formula."""
    if x.shape[-1] % 128 == 0 and x.shape[1] >= 256:
        return fused_rms_modulate(x, weight, scale, eps)
    return rms_modulate_plain(x, weight, scale, eps)


def vae_rms_silu_plain(x, gamma, silu: bool = True):
    """Plain version of K11 (the JAX package's ``_vae_rms_silu_reference``):
    x / max(‖x‖, 1e-12) · √C · γ over the last axis in fp32, rounded to
    x.dtype; then, for ``silu``, SiLU in fp32, rounded again."""
    xf = x.float()
    n = torch.sqrt((xf * xf).sum(-1, keepdim=True))
    y = xf / torch.clamp_min(n, 1e-12) * (x.shape[-1] ** 0.5)
    out = (y * gamma.float()).to(x.dtype)
    if silu:
        out = F.silu(out.float()).to(x.dtype)
    return out


def fused_vae_rms_silu(x, gamma, silu: bool = True):
    """K11: x (..., C) viewed as (rows, C) rows; gamma (C,) cast to x.dtype,
    as the Pallas wrapper casts it.  bf16 or fp32; one warp per row, so C
    <= 256 x 16 bytes / element size."""
    if _needs_grad(x, gamma):
        return _VaeRmsSilu.apply(x, gamma, silu)
    if not x.is_cuda:
        return vae_rms_silu_plain(x, gamma, silu)
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vae_rms_silu kernel takes bf16 or fp32, got {x.dtype}")
    vec = 16 // x.element_size()
    if c % vec or c > 32 * 8 * vec:
        raise ValueError(f"vae_rms_silu kernel needs C % {vec} == 0 and C <= {256 * vec}, "
                         f"got {c}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    x2 = x.view(-1, c)
    _kernels.check_cuda(x2, "x", x.dtype, 2)
    g = gamma.to(x.dtype).contiguous()
    _kernels.check_cuda(g, "gamma", x.dtype, 1)
    if g.shape[0] != c:
        raise ValueError(f"gamma must be ({c},), got {tuple(gamma.shape)}")
    out = torch.empty_like(x)
    _kernels.launch("vae_rms_silu", "fg_vae_rms_silu", x2.data_ptr(), g.data_ptr(),
                    out.data_ptr(), x2.shape[0], c, int(silu), int(x.dtype == torch.float32))
    return out


class _VaeRmsSilu(torch.autograd.Function):
    """Forward K11 (through :func:`fused_vae_rms_silu`, grad off), backward
    the autograd of :func:`vae_rms_silu_plain` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, silu):
        ctx.save_for_backward(x, gamma)
        ctx.silu = silu
        return fused_vae_rms_silu(x, gamma, silu)

    @staticmethod
    def backward(ctx, g):
        grads = _plain_grads(ctx, lambda x, gm: vae_rms_silu_plain(x, gm, ctx.silu), g)
        return grads + (None,)


def vae_rms_silu(x, gamma, silu: bool = True):
    """Channel RMS norm (F.normalize·√C·γ, the Wan VAE form) + optional
    SiLU over the last axis of x (..., C).  The JAX package's gate: C %
    128 == 0 and at least 512 rows go to K11, anything else to the plain
    formula."""
    c = x.shape[-1]
    if c % 128 == 0 and x.numel() // c >= 512:
        return fused_vae_rms_silu(x, gamma, silu)
    return vae_rms_silu_plain(x, gamma, silu)
