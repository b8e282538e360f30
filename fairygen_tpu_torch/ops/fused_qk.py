"""K2, K7, K8: rms -> RoPE -> head-major q/k prep, and the DiT attention
entries built on them (port of fairygen_tpu/ops/fused_qk.py).

K2 applies a row statistic computed outside (the Wan DiT); K7 computes the
rms over each head's own 128 lanes (the FLUX.1 single blocks and every
Z-Image block); K8 does K7 for two streams, image then text, into one
buffer with zero gap rows (the FLUX.1 double blocks' joint attention).

The rotation of adjacent pairs (2i, 2i+1) uses full-width tables:
``cos_full[s, j] = cos[s, j // 2]`` and ``sin_sign[s, j] = ∓sin[s, j // 2]``
(minus on even j), so ``rope(y) = y * cos_full + swap_adjacent(y) * sin_sign``.

CUDA tensors go through ``csrc/rms_rope.cu`` (bf16, head_dim 128); CPU
tensors take the ``*_plain`` versions.

The attention entries' gradients recompute the plain chain (rms_norm ->
RoPE -> ``attention(prescaled=True, bounded_logits=True)``) and
differentiate it, as the JAX package's custom VJPs do; on CUDA that
attention is the K6a/K6b/K6c flash attention.
"""
from __future__ import annotations

import torch

from . import _kernels
from .attention import attention
from .flash_attention import LOG2E, flash_attention_heads_major
from .norms import rms_norm
from .rope import apply_interleaved_rope, rope_apply

_PREP_BQ = 512


def build_freqs_full_pairs(cos, sin) -> torch.Tensor:
    """(L, hd/2) interleaved-pair tables -> (2, L, hd) full-width
    (cos_full, sin_sign) fp32 tables."""
    cos_full = cos.repeat_interleave(2, dim=-1)
    sin_full = sin.repeat_interleave(2, dim=-1)
    sign = torch.tensor([-1.0, 1.0], dtype=torch.float32, device=cos.device).repeat(cos.shape[-1])
    return torch.stack([cos_full, sin_full * sign]).contiguous()


def build_freqs_full(freqs: torch.Tensor) -> torch.Tensor:
    """(2, S, hd/2) (cos, sin) pair tables -> (2, S, hd) full-width
    (cos_full, sin_sign) fp32 tables."""
    return build_freqs_full_pairs(freqs[0], freqs[1])


def build_freqs_full_joint(cos_img, sin_img, cos_txt, sin_txt, i_pad: int,
                           s_pad: int) -> torch.Tensor:
    """Per-stream (L, hd/2) pair tables -> (2, s_pad, hd) full-width tables
    in K8's output-row order: image rows at 0, text rows at ``i_pad``, gap
    rows zero (their outputs are zero rows whatever the table holds)."""
    fi = build_freqs_full_pairs(cos_img, sin_img)
    ft = build_freqs_full_pairs(cos_txt, sin_txt)
    out = fi.new_zeros((2, s_pad, fi.shape[-1]))
    out[:, :fi.shape[1]] = fi
    out[:, i_pad:i_pad + ft.shape[1]] = ft
    return out


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


def _rotate_heads_major(y, freqs_full, s_pad: int, rope: bool = True):
    """y (B, S, N, hd) normed rows -> (B*N, s_pad, hd): the adjacent-pair
    rotation ``y·cos_full + swap(y)·sin_sign`` in fp32 (rows of the table
    taken in order), rounded to y.dtype, head-major, rows >= S zero."""
    b, s, n, hd = y.shape
    if rope:
        yf = y.float()
        swp = yf.reshape(b, s, n, hd // 2, 2).flip(-1).reshape(b, s, n, hd)
        cos = freqs_full[0, :s][None, :, None, :]
        sin = freqs_full[1, :s][None, :, None, :]
        y = (yf * cos + swp * sin).to(y.dtype)
    out = y.new_zeros((b, n, s_pad, hd))
    out[:, :, :s] = y.permute(0, 2, 1, 3)
    return out.reshape(b * n, s_pad, hd)


def rms_rope_heads_major_plain(x, gamma, rowscale, freqs_full, n_heads: int,
                               s_pad: int, *, rope: bool = True):
    """Plain version of K2: same arithmetic, same rounding points."""
    b, s, d = x.shape
    y = (x.float() * rowscale[..., None]).to(x.dtype) * gamma
    return _rotate_heads_major(y.reshape(b, s, n_heads, d // n_heads), freqs_full, s_pad, rope)


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


# --------------------------------------------------------------------------
# K7 / K8: per-head rms (gamma (hd,) shared by the heads) inside the kernel,
# interleaved RoPE, head-major store (port of ``_prep_kernel_per_head`` and
# ``_prep_kernel_joint``).  The inputs may be column slices of a fused
# projection output: a row stride is passed, the last dim must be dense.

def _per_head_norm(x, gamma, n_heads: int, eps: float):
    """rsqrt(mean over the head's hd lanes + eps) in fp32, rounded to
    x.dtype, then ·gamma in x.dtype: (B, S, N·hd) -> (B, S, N, hd)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, n_heads, d // n_heads)
    rs = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * rs).to(x.dtype) * gamma


def rms_rope_heads_major_per_head_plain(x, gamma, freqs_full, n_heads: int, s_pad: int, *,
                                        eps: float):
    """Plain version of K7."""
    return _rotate_heads_major(_per_head_norm(x, gamma, n_heads, eps), freqs_full, s_pad)


def rms_rope_heads_major_joint_plain(x_img, x_txt, g_img, g_txt, ff_joint, n_heads: int,
                                     i_pad: int, s_pad: int, *, eps: float):
    """Plain version of K8: each stream through K7's arithmetic, the image
    rows at 0 and the text rows at ``i_pad`` of one buffer."""
    b = x_img.shape[0]
    img = rms_rope_heads_major_per_head_plain(x_img, g_img, ff_joint[:, :i_pad], n_heads,
                                              i_pad, eps=eps)
    txt = rms_rope_heads_major_per_head_plain(x_txt, g_txt, ff_joint[:, i_pad:], n_heads,
                                              s_pad - i_pad, eps=eps)
    hd = img.shape[-1]
    return torch.cat([img.reshape(b * n_heads, i_pad, hd),
                      txt.reshape(b * n_heads, s_pad - i_pad, hd)], dim=1)


def _row_view(x, name, n_heads):
    """Raise unless x is a bf16 (B, S, N·128) CUDA view whose rows are dense
    and 16-byte aligned; returns its row stride in elements."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{name}: expected a bf16 (B, S, D) CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    b, s, d = x.shape
    if d != n_heads * 128:
        raise ValueError(f"{name}: the per-head prep kernels need head_dim 128, got {d} / "
                         f"{n_heads}")
    if x.stride(2) != 1 or x.stride(1) % 8 or x.data_ptr() % 16 or \
            (b > 1 and x.stride(0) != s * x.stride(1)):
        raise ValueError(f"{name}: rows must be dense, 16-byte aligned and evenly spaced, "
                         f"got strides {x.stride()}")
    return x.stride(1)


def _check_table(ff, rows):
    _kernels.check_cuda(ff, "freqs_full", torch.float32, 3)
    if ff.shape[0] != 2 or ff.shape[1] < rows or ff.shape[2] != 128:
        raise ValueError(f"freqs_full must be (2, >= {rows}, 128), got {tuple(ff.shape)}")


def rms_rope_heads_major_per_head(x, gamma, freqs_full, n_heads: int, s_pad: int, *,
                                  eps: float):
    """K7: (B, S, N·hd) -> (B·N, s_pad, hd) head-major, per-head rms-normed
    and rotated, rows >= S exactly zero.  gamma (hd,); freqs_full (2, >= S,
    hd) fp32 from :func:`build_freqs_full_pairs`."""
    if not x.is_cuda:
        return rms_rope_heads_major_per_head_plain(x, gamma, freqs_full, n_heads, s_pad,
                                                   eps=eps)
    b, s, _ = x.shape
    stride = _row_view(x, "x", n_heads)
    _kernels.check_cuda(gamma, "gamma", torch.bfloat16, 1)
    _check_table(freqs_full, s)
    if gamma.shape[0] != 128 or s_pad < s:
        raise ValueError(f"gamma must be (128,) and s_pad >= S, got {tuple(gamma.shape)}, "
                         f"{s_pad} < {s}")
    out = torch.empty((b * n_heads, s_pad, 128), dtype=x.dtype, device=x.device)
    _kernels.launch("rms_rope_per_head", "fg_rms_rope_per_head", x.data_ptr(), stride,
                    gamma.data_ptr(), freqs_full[0].data_ptr(), freqs_full[1].data_ptr(),
                    out.data_ptr(), b, s, n_heads, s_pad, float(eps))
    return out


def rms_rope_heads_major_joint(x_img, x_txt, g_img, g_txt, ff_joint, n_heads: int,
                               i_pad: int, s_pad: int, *, eps: float):
    """K8: two streams into one (B·N, s_pad, hd) buffer — image rows at 0,
    text rows at ``i_pad``, every other row exactly zero.  ff_joint (2,
    s_pad, hd) in output-row order (:func:`build_freqs_full_joint`)."""
    if not x_img.is_cuda:
        return rms_rope_heads_major_joint_plain(x_img, x_txt, g_img, g_txt, ff_joint, n_heads,
                                                i_pad, s_pad, eps=eps)
    b, s_img, _ = x_img.shape
    s_txt = x_txt.shape[1]
    si, st = _row_view(x_img, "x_img", n_heads), _row_view(x_txt, "x_txt", n_heads)
    for name, g in (("g_img", g_img), ("g_txt", g_txt)):
        _kernels.check_cuda(g, name, torch.bfloat16, 1)
        if g.shape[0] != 128:
            raise ValueError(f"{name} must be (128,)")
    _check_table(ff_joint, s_pad)
    if x_txt.shape[0] != b or s_img > i_pad or i_pad + s_txt > s_pad:
        raise ValueError(f"streams {s_img} + {s_txt} do not fit i_pad {i_pad}, s_pad {s_pad}")
    out = torch.empty((b * n_heads, s_pad, 128), dtype=x_img.dtype, device=x_img.device)
    _kernels.launch("rms_rope_joint", "fg_rms_rope_joint", x_img.data_ptr(), si,
                    x_txt.data_ptr(), st, g_img.data_ptr(), g_txt.data_ptr(),
                    ff_joint[0].data_ptr(), ff_joint[1].data_ptr(), out.data_ptr(), b, s_img,
                    s_txt, n_heads, i_pad, s_pad, float(eps))
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
    """Gradients of ``chain(*saved, *static)`` for the inputs that need one
    (``g`` a tuple when the chain returns one)."""
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


# --------------------------------------------------------------------------
# The image-DiT entries on K7 / K8 (port of ``fused_qk_attention_per_head``
# and ``fused_qk_attention_joint``).

def _fold(gamma_q, hd: int, fold_scale: bool):
    """gamma_q·hd^-1/2·log2e in fp32, rounded back to gamma's dtype (the
    JAX package's fold), or gamma_q as given."""
    if not fold_scale:
        return gamma_q
    c = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32, device=gamma_q.device)
    return (gamma_q.float() * c).to(gamma_q.dtype)


def _reference_chain_per_head(xq, xk, v, gamma_q, gamma_k, cos, sin, n_heads, eps,
                              fold_scale):
    """The plain per-head chain: per-head rms -> interleaved RoPE -> bounded
    attention (``prescaled`` unless the scale is still to fold)."""
    b, s, d = xq.shape
    hd = d // n_heads
    q = rms_norm(xq.reshape(b, s, n_heads, hd), gamma_q, eps)
    k = rms_norm(xk.reshape(b, s, n_heads, hd), gamma_k, eps)
    q = apply_interleaved_rope(q, cos, sin)
    k = apply_interleaved_rope(k, cos, sin)
    return attention(q, k, v, prescaled=not fold_scale, bounded_logits=True)


def _reference_chain_joint(xq_t, xk_t, v_t, xq_i, xk_i, v_i, gq_t, gk_t, gq_i, gk_i,
                           cos_t, sin_t, cos_i, sin_i, n_heads, eps, fold_scale):
    """The plain joint chain: per-stream rms and RoPE, text-first concat,
    bounded attention; returns (o_txt, o_img)."""
    b, s_t, d = xq_t.shape
    s_i = xq_i.shape[1]
    hd = d // n_heads

    def prep(x, g, s, cos, sin):
        return apply_interleaved_rope(rms_norm(x.reshape(b, s, n_heads, hd), g, eps), cos, sin)

    q = torch.cat([prep(xq_t, gq_t, s_t, cos_t, sin_t), prep(xq_i, gq_i, s_i, cos_i, sin_i)], 1)
    k = torch.cat([prep(xk_t, gk_t, s_t, cos_t, sin_t), prep(xk_i, gk_i, s_i, cos_i, sin_i)], 1)
    o = attention(q, k, torch.cat([v_t, v_i], 1), prescaled=not fold_scale,
                  bounded_logits=True)
    return o[:, :s_t], o[:, s_t:]


class _FusedPerHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, xk, v, gamma_q, gamma_k, cos, sin, n_heads, eps, fold_scale):
        ctx.save_for_backward(xq, xk, v, gamma_q, gamma_k, cos, sin)
        ctx.static = (n_heads, eps, fold_scale)
        return fused_qk_attention_per_head(xq, xk, v, gamma_q, gamma_k, cos, sin, n_heads, eps,
                                           fold_scale)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, _reference_chain_per_head, g, *ctx.static)
        return tuple(grads) + (None, None, None)


class _FusedJoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args[:14])
        ctx.static = args[14:]
        return fused_qk_attention_joint(*args)

    @staticmethod
    def backward(ctx, g_t, g_i):
        grads = _recompute_grads(ctx, _reference_chain_joint, (g_t, g_i), *ctx.static)
        return tuple(grads) + (None, None, None)


def fused_qk_attention_per_head(xq, xk, v, gamma_q, gamma_k, cos, sin, n_heads: int,
                                eps: float, fold_scale: bool = True):
    """Self-attention from raw q/k projections for the per-head-rms,
    interleaved-RoPE image DiTs (the FLUX.1 single blocks, the Z-Image
    blocks): K7 on q and k, then the bounded attention (K3, or K4 for one
    k tile).

    xq/xk (B, S, N·hd), v (B, S, N, hd), gamma_q/k (hd,), cos/sin (S, hd/2)
    pair tables.  ``fold_scale``: fold hd^-1/2·log2e into the raw gamma_q
    here (Z-Image; FLUX.1 unless prescaled); False when the converter
    already did.  Returns (B, S, N, hd).  The
    gradient differentiates the plain chain."""
    if _needs_grad(xq, xk, v, gamma_q, gamma_k):
        return _FusedPerHead.apply(xq, xk, v, gamma_q, gamma_k, cos, sin, n_heads, eps,
                                   fold_scale)
    b, s, d = xq.shape
    hd = d // n_heads
    ff = build_freqs_full_pairs(cos, sin)
    s_pad, bq, bk = _pad_for_flash(s)
    qh = rms_rope_heads_major_per_head(xq, _fold(gamma_q, hd, fold_scale), ff, n_heads, s_pad,
                                       eps=eps)
    kh = rms_rope_heads_major_per_head(xk, gamma_k, ff, n_heads, s_pad, eps=eps)
    return flash_attention_heads_major(qh, kh, v.contiguous(), b=b, n=n_heads, sq=s,
                                       sk_actual=s, bq=bq, bk=bk)


def fused_qk_attention_joint(xq_t, xk_t, v_t, xq_i, xk_i, v_i, gq_t, gk_t, gq_i, gk_i,
                             cos_t, sin_t, cos_i, sin_i, n_heads: int, eps: float,
                             fold_scale: bool = True):
    """Joint text+image self-attention of the FLUX.1 double blocks from raw
    per-stream projections: K8 on q and k, then the bounded attention over
    one buffer with the image rows at 0 (padded to a multiple of 1024) and
    the text rows after them.  The zero gap rows each add exactly 1 to every
    row sum, which the count correction of K3/K4 removes; v is laid out in
    the same row order, with zero gap rows.

    Returns (o_txt, o_img), each (B, L, N, hd), the reference order.  The
    gradient differentiates the plain chain."""
    args = (xq_t, xk_t, v_t, xq_i, xk_i, v_i, gq_t, gk_t, gq_i, gk_i, cos_t, sin_t, cos_i,
            sin_i, n_heads, eps, fold_scale)
    if _needs_grad(*args[:10]):
        return _FusedJoint.apply(*args)
    b, s_i, d = xq_i.shape
    s_t = xq_t.shape[1]
    hd = d // n_heads
    i_pad = -(-s_i // 1024) * 1024
    s_pad = i_pad + -(-s_t // 1024) * 1024
    bq = 2048 if s_pad % 2048 == 0 else 1024
    ff = build_freqs_full_joint(cos_i, sin_i, cos_t, sin_t, i_pad, s_pad)
    qh = rms_rope_heads_major_joint(xq_i, xq_t, _fold(gq_i, hd, fold_scale),
                                    _fold(gq_t, hd, fold_scale), ff, n_heads, i_pad, s_pad,
                                    eps=eps)
    kh = rms_rope_heads_major_joint(xk_i, xk_t, gk_i, gk_t, ff, n_heads, i_pad, s_pad, eps=eps)
    v = v_i.new_zeros((b, i_pad + s_t, n_heads, hd))
    v[:, :s_i] = v_i
    v[:, i_pad:] = v_t
    o = flash_attention_heads_major(qh, kh, v, b=b, n=n_heads, sq=i_pad + s_t,
                                    sk_actual=s_i + s_t, bq=bq, bk=1024)
    return o[:, i_pad:], o[:, :s_i]
