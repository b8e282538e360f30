"""K2: rms-apply -> RoPE -> head-major q/k prep, and the DiT attention
entries built on it (port of fairygen_tpu/ops/fused_qk.py).

The rotation of adjacent pairs (2i, 2i+1) uses full-width tables:
``cos_full[s, j] = cos[s, j // 2]`` and ``sin_sign[s, j] = ∓sin[s, j // 2]``
(minus on even j), so ``rope(y) = y * cos_full + swap_adjacent(y) * sin_sign``.

CUDA tensors go through ``csrc/rms_rope.cu`` (bf16, head_dim 128); CPU
tensors take :func:`rms_rope_heads_major_plain`.

The attention entries' gradients recompute the plain chain (rms_norm ->
RoPE -> ``attention(prescaled=True, bounded_logits=True)``) and
differentiate it, as the JAX package's ``_fused_vjp_bwd`` and
``_fused_q_vjp_bwd`` do; on CUDA that attention is the K6a/K6b/K6c flash
attention.
"""
from __future__ import annotations

import torch

from . import _kernels
from .attention import attention
from .flash_attention import flash_attention_heads_major
from .norms import rms_norm
from .rope import rope_apply

_PREP_BQ = 512


def build_freqs_full(freqs: torch.Tensor) -> torch.Tensor:
    """(2, S, hd/2) (cos, sin) pair tables -> (2, S, hd) full-width
    (cos_full, sin_sign) fp32 tables."""
    cos_full = freqs[0].repeat_interleave(2, dim=-1)
    sin_full = freqs[1].repeat_interleave(2, dim=-1)
    sign = torch.tensor([-1.0, 1.0], dtype=torch.float32,
                        device=freqs.device).repeat(freqs.shape[-1])
    return torch.stack([cos_full, sin_full * sign]).contiguous()


def _rowscale(x, eps: float):
    """rsqrt(mean(x²) + eps) per row in fp32 — the rms statistic pass the
    prep kernel consumes (plain XLA in the JAX package too)."""
    xf = x.float()
    return torch.rsqrt(xf.pow(2).mean(-1) + eps)


def _pad_for_flash(s: int):
    """(s_pad, bq, bk): s_pad rounds up to a multiple of 1024 (at least
    512); the TPU tiles bq/bk decide which attention kernel runs (one k tile
    of bk rows -> K4, several -> K3)."""
    s_pad = max(-(-s // 1024) * 1024, _PREP_BQ)
    bq = 2048 if s_pad % 2048 == 0 else 1024
    bk = 1024
    return s_pad, min(bq, s_pad), min(bk, s_pad)


def rms_rope_heads_major_plain(x, gamma, rowscale, freqs_full, n_heads: int,
                               s_pad: int, *, rope: bool = True):
    """Plain version of K2: same arithmetic, same rounding points."""
    b, s, d = x.shape
    hd = d // n_heads
    y = (x.float() * rowscale[..., None]).to(x.dtype) * gamma
    y = y.reshape(b, s, n_heads, hd)
    if rope:
        yf = y.float()
        swp = yf.reshape(b, s, n_heads, hd // 2, 2).flip(-1).reshape(b, s, n_heads, hd)
        cos = freqs_full[0, :s][None, :, None, :]
        sin = freqs_full[1, :s][None, :, None, :]
        y = (yf * cos + swp * sin).to(x.dtype)
    out = x.new_zeros((b, n_heads, s_pad, hd))
    out[:, :, :s] = y.permute(0, 2, 1, 3)
    return out.reshape(b * n_heads, s_pad, hd)


def rms_rope_heads_major(x, gamma, rowscale, freqs_full, n_heads: int,
                         s_pad: int, *, rope: bool = True):
    """(B, S, N*hd) -> (B*N, s_pad, hd) head-major, normalized (+RoPE), rows
    >= S exactly zero.  rowscale (B, S) fp32 from :func:`_rowscale`;
    gamma (N*hd,); freqs_full (2, >= S, hd) fp32 (unused when rope=False)."""
    if not x.is_cuda:
        return rms_rope_heads_major_plain(x, gamma, rowscale, freqs_full,
                                          n_heads, s_pad, rope=rope)
    b, s, d = x.shape
    if d != n_heads * 128:
        raise ValueError(f"rms_rope kernel needs head_dim 128, got {d} / {n_heads}")
    if s_pad < s:
        raise ValueError(f"s_pad {s_pad} < S {s}")
    _kernels.check_cuda(x, "x", torch.bfloat16, 3)
    _kernels.check_cuda(gamma, "gamma", torch.bfloat16, 1)
    _kernels.check_cuda(rowscale, "rowscale", torch.float32, 2)
    if gamma.shape[0] != d or rowscale.shape != (b, s):
        raise ValueError("gamma must be (D,) and rowscale (B, S)")
    cos_ptr = sin_ptr = 0
    if rope:
        _kernels.check_cuda(freqs_full, "freqs_full", torch.float32, 3)
        if freqs_full.shape[0] != 2 or freqs_full.shape[1] < s or freqs_full.shape[2] != 128:
            raise ValueError(f"freqs_full must be (2, >= {s}, 128), got {tuple(freqs_full.shape)}")
        cos_ptr = freqs_full[0].data_ptr()
        sin_ptr = freqs_full[1].data_ptr()
    out = torch.empty((b * n_heads, s_pad, 128), dtype=x.dtype, device=x.device)
    _kernels.launch("rms_rope_heads_major", "fg_rms_rope_heads_major", x.data_ptr(),
                    rowscale.data_ptr(), gamma.data_ptr(), cos_ptr, sin_ptr,
                    out.data_ptr(), b, s, n_heads, s_pad, int(rope))
    return out


def _pair_freqs(freqs_full):
    """(2, S, hd) (cos_full, sin_sign) -> the (2, S, hd/2) pair tables."""
    return torch.stack([freqs_full[0, :, 0::2], freqs_full[1, :, 1::2]])


def _reference_chain(xq, xk, v, gamma_q, gamma_k, freqs, n_heads, eps):
    """The plain chain the self-attention gradient differentiates."""
    b, s, d = xq.shape
    hd = d // n_heads
    q = rope_apply(rms_norm(xq, gamma_q, eps).reshape(b, s, n_heads, hd), freqs)
    k = rope_apply(rms_norm(xk, gamma_k, eps).reshape(b, s, n_heads, hd), freqs)
    return attention(q, k, v, prescaled=True, bounded_logits=True)


def _cross_reference_chain(xq, k, v, gamma_q, n_heads, eps):
    """The plain chain the cross-attention gradient differentiates."""
    b, s, d = xq.shape
    q = rms_norm(xq, gamma_q, eps).reshape(b, s, n_heads, d // n_heads)
    return attention(q, k, v, prescaled=True, bounded_logits=True)


def _recompute_grads(ctx, chain, g, *static):
    """Gradients of ``chain(*saved, *static)`` for the inputs that need one."""
    saved = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = chain(*inputs, *static)
    grads = iter(torch.autograd.grad(out, wanted, g))
    return [next(grads) if t.requires_grad else None for t in inputs]


class _FusedQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, xk, v, gamma_q, gamma_k, freqs_full, n_heads, eps):
        ctx.save_for_backward(xq, xk, v, gamma_q, gamma_k, freqs_full)
        ctx.static = (n_heads, eps)
        return fused_qk_attention(xq, xk, v, gamma_q, gamma_k, freqs_full, n_heads, eps)

    @staticmethod
    def backward(ctx, g):
        n_heads, eps = ctx.static
        grads = _recompute_grads(
            ctx, lambda xq, xk, v, gq, gk, ff: _reference_chain(xq, xk, v, gq, gk,
                                                                _pair_freqs(ff), n_heads, eps),
            g)
        return tuple(grads[:5]) + (None, None, None)


class _FusedQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, k, v, gamma_q, n_heads, eps):
        ctx.save_for_backward(xq, k, v, gamma_q)
        ctx.static = (n_heads, eps)
        return fused_q_attention(xq, k, v, gamma_q, n_heads, eps)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, _cross_reference_chain, g, *ctx.static)
        return tuple(grads) + (None, None)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_qk_attention(xq, xk, v, gamma_q, gamma_k, freqs_full, n_heads: int,
                       eps: float):
    """Self-attention from raw q/k projections: K2 on q and k, then the
    bounded attention (K3, or K4 when s_pad is one k tile).

    xq/xk (B, S, D) projections, v (B, S, N, hd); gamma_q MUST be
    pre-scaled by hd^-1/2·log2e.  Returns (B, S, N, hd).  Gradients for
    xq, xk, v and both gammas."""
    if _needs_grad(xq, xk, v, gamma_q, gamma_k):
        return _FusedQK.apply(xq, xk, v, gamma_q, gamma_k, freqs_full, n_heads, eps)
    b, s, _ = xq.shape
    s_pad, bq, bk = _pad_for_flash(s)
    qh = rms_rope_heads_major(xq, gamma_q, _rowscale(xq, eps), freqs_full,
                              n_heads, s_pad)
    kh = rms_rope_heads_major(xk, gamma_k, _rowscale(xk, eps), freqs_full,
                              n_heads, s_pad)
    return flash_attention_heads_major(qh, kh, v, b=b, n=n_heads, sq=s,
                                       sk_actual=s, bq=bq, bk=bk)


def fused_q_attention(xq, k, v, gamma_q, n_heads: int, eps: float):
    """Cross-attention with the q side through K2 (``rope=False``): k/v are
    already per-head (B, Lk, N, hd) (rms-normed k); gamma_q pre-scaled by
    hd^-1/2·log2e.  Returns (B, S, N, hd).  Gradients for xq, k, v and
    gamma_q."""
    if _needs_grad(xq, k, v, gamma_q):
        return _FusedQ.apply(xq, k, v, gamma_q, n_heads, eps)
    b, s, _ = xq.shape
    lk, hd = k.shape[1], k.shape[3]
    s_pad, bq, _ = _pad_for_flash(s)
    qh = rms_rope_heads_major(xq, gamma_q, _rowscale(xq, eps), None, n_heads,
                              s_pad, rope=False)
    # one k tile of the padded text length (K4); several of 1024 past that
    bk = max(128, -(-lk // 128) * 128) if lk <= 1024 else 1024
    sk_pad = -(-lk // bk) * bk
    kh = k.new_zeros((b, n_heads, sk_pad, hd))
    kh[:, :, :lk] = k.permute(0, 2, 1, 3)
    return flash_attention_heads_major(qh, kh.reshape(b * n_heads, sk_pad, hd), v,
                                       b=b, n=n_heads, sq=s, sk_actual=lk, bq=bq, bk=bk)
