"""K3 / K4: bounded-logits attention on head-major q/k (port of
fairygen_tpu/ops/flash_attention.py ``flash_attention_heads_major`` with
``natural_out=True``; kernels ``_fa_kernel_bounded`` and
``_fa_small_kv_kernel``).

Contract: qh (B*N, Sq_pad, d) carries the hd^-1/2·log2e prescale; q and k
are rms-normed, so softmax == exp2(s) / Σ exp2(s) without a running max;
kh (B*N, Sk_pad, d) rows >= sk_actual are exact zeros, each adding exactly
1 to the row sum, which ``l -= Sk_pad - sk_actual`` removes.  v is
(B, Lv, N, d) in its natural layout.  The output is (B, sq, N, d).

CUDA tensors go through ``csrc/flash_attention.cu`` (bf16, d = 128): K4
when the keys are one TPU k tile (Sk_pad == bk), K3 otherwise.  CPU tensors
take :func:`flash_attention_heads_major_plain`.
"""
from __future__ import annotations

import torch

from . import _kernels


def flash_attention_heads_major_plain(qh, kh, v, *, b, n, sq, sk_actual):
    """Plain version of K3/K4: fp32 logits, exp2, fp32 sum with the pad
    correction, bf16-rounded p times v accumulated in fp32 — one head at a
    time so the (Sq, Sk) logits of a single head are the largest buffer."""
    d = qh.shape[-1]
    sk_p = kh.shape[1]
    lv = v.shape[1]
    out = qh.new_empty((b, sq, n, d))
    for bn in range(b * n):
        bi, ni = divmod(bn, n)
        s = qh[bn, :sq].float() @ kh[bn].float().T
        p = torch.exp2(s)
        l = p.sum(-1, keepdim=True) - float(sk_p - sk_actual)
        vh = v.new_zeros((sk_p, d))
        vh[:lv] = v[bi, :, ni]
        pv = p.to(v.dtype).float() @ vh.float()
        out[bi, :, ni] = (pv / l).to(qh.dtype)
    return out


def flash_attention_heads_major(qh, kh, v, *, b, n, sq, sk_actual, bq=2048,
                                bk=1024):
    """Bounded attention on pre-formatted head-major q/k (see module doc).
    bq/bk are the TPU tiles: Sq_pad % bq == 0 and Sk_pad % bk == 0; a single
    k tile (Sk_pad == bk) selects K4, several select K3."""
    d = qh.shape[-1]
    sq_p, sk_p = qh.shape[1], kh.shape[1]
    if sq_p % bq or sk_p % bk:
        raise ValueError(f"padded lengths {(sq_p, sk_p)} are not multiples of {(bq, bk)}")
    if not qh.is_cuda:
        return flash_attention_heads_major_plain(qh, kh, v, b=b, n=n, sq=sq,
                                                 sk_actual=sk_actual)
    _kernels.check_cuda(qh, "qh", torch.bfloat16, 3)
    _kernels.check_cuda(kh, "kh", torch.bfloat16, 3)
    _kernels.check_cuda(v, "v", torch.bfloat16, 4)
    lv = v.shape[1]
    if d != 128 or qh.shape[0] != b * n or kh.shape[0] != b * n or kh.shape[2] != d:
        raise ValueError(f"attention kernels need (B*N, S_pad, 128) q/k, got "
                         f"{tuple(qh.shape)} / {tuple(kh.shape)}")
    if v.shape != (b, lv, n, d) or lv > sk_p or sk_actual > sk_p or sq > sq_p:
        raise ValueError(f"v {tuple(v.shape)} does not match b={b} n={n} sk_pad={sk_p}")
    if sq_p % 64 or sk_p % 64:
        raise ValueError("padded lengths must be multiples of 64")
    out = torch.empty((b, sq, n, d), dtype=qh.dtype, device=qh.device)
    if sk_p == bk:
        kernel, fn = "flash_small_kv", "fg_flash_small_kv"
    else:
        kernel, fn = "flash_bounded", "fg_flash_bounded"
    _kernels.launch(kernel, fn, qh.data_ptr(), kh.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, n, sq, sq_p, int(sk_actual), sk_p, lv)
    return out


# --------------------------------------------------------------------------
# K5 / K6a / K6b / K6c: the generic entry and its gradient (port of
# ``flash_attention`` with its custom VJP, ``_flash_fwd_impl``,
# ``_flash_fwd`` and ``_flash_bwd``).  The kernels take head-major bf16
# (B*N, S_pad, 128) q/k/v, zero rows past the sequence, S_pad a multiple of
# 64; lse and delta are one fp32 value per row.  CPU tensors take the
# ``*_plain`` versions, which compute what the Pallas kernels compute on one
# tile: fp32 logits, keys >= sk_actual masked, p rounded to the value dtype
# before each product, fp32 accumulation.

DEFAULT_BQ = 1024
DEFAULT_BK = 1024
LOG2E = 1.4426950408889634
_ROW_TILE = 64  # rows per CTA of the CUDA kernels


def _masked_logits(qh, kh, bn, sk_actual):
    s = qh[bn].float() @ kh[bn].float().T
    s[:, sk_actual:] = float("-inf")
    return s


def flash_fwd_plain(qh, kh, vh, *, sk_actual, with_lse=True):
    """Plain version of K5 (``with_lse=False``) and K6a: softmax in base 2
    with the row max, one head at a time.  Returns o (BN, Sq_pad, d) in
    q's dtype and, with ``with_lse``, lse = m + log2(l) (BN, Sq_pad) fp32."""
    out = torch.empty_like(qh)
    lse = qh.new_empty(qh.shape[:2], dtype=torch.float32)
    for bn in range(qh.shape[0]):
        s = _masked_logits(qh, kh, bn, sk_actual)
        m = s.max(-1, keepdim=True).values
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        out[bn] = ((p.to(vh.dtype).float() @ vh[bn].float()) / l).to(qh.dtype)
        lse[bn] = (m + torch.log2(l))[:, 0]
    return (out, lse) if with_lse else out


def flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta, *, sk_actual, dq_factor):
    """Plain version of K6b: dQ = f * [P o (dP - delta)] K."""
    dq = torch.empty_like(qh)
    for bn in range(qh.shape[0]):
        p = torch.exp2(_masked_logits(qh, kh, bn, sk_actual) - lse[bn, :, None])
        dp = doh[bn].float() @ vh[bn].float().T
        ds = p * (dp - delta[bn, :, None])
        dq[bn] = ((ds.to(kh.dtype).float() @ kh[bn].float()) * dq_factor).to(qh.dtype)
    return dq


def flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, *, sq, sk_actual):
    """Plain version of K6c: dV = P^T dO, dK = [P o (dP - delta)]^T Q /
    log2(e); queries >= sq contribute nothing."""
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    for bn in range(qh.shape[0]):
        p = torch.exp2(_masked_logits(qh, kh, bn, sk_actual) - lse[bn, :, None])
        p[sq:] = 0.0
        dv[bn] = (p.to(doh.dtype).float().T @ doh[bn].float()).to(vh.dtype)
        dp = doh[bn].float() @ vh[bn].float().T
        ds = p * (dp - delta[bn, :, None])
        dk[bn] = ((ds.to(qh.dtype).float().T @ qh[bn].float()) * (1.0 / LOG2E)).to(kh.dtype)
    return dk, dv


def _check_heads_major(qh, kh, vh, sk_actual, extra=()):
    for name, t in (("qh", qh), ("kh", kh), ("vh", vh)) + tuple(extra):
        _kernels.check_cuda(t, name, torch.bfloat16, 3)
    if qh.shape[2] != 128 or kh.shape != vh.shape or kh.shape[0] != qh.shape[0] \
            or kh.shape[2] != 128:
        raise ValueError(f"flash kernels need (BN, S_pad, 128) q/k/v, got {tuple(qh.shape)} / "
                         f"{tuple(kh.shape)} / {tuple(vh.shape)}")
    if qh.shape[1] % _ROW_TILE or kh.shape[1] % _ROW_TILE:
        raise ValueError("padded lengths must be multiples of 64")
    if not 1 <= sk_actual <= kh.shape[1]:
        raise ValueError(f"sk_actual {sk_actual} outside [1, {kh.shape[1]}]")


def _check_rows(t, name, shape):
    _kernels.check_cuda(t, name, torch.float32, 2)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def flash_fwd(qh, kh, vh, *, sk_actual, with_lse=True):
    """K6a (``with_lse``) or K5 on head-major q/k/v (see the section note).
    Returns o, and lse with ``with_lse``."""
    if not qh.is_cuda:
        return flash_fwd_plain(qh, kh, vh, sk_actual=sk_actual, with_lse=with_lse)
    _check_heads_major(qh, kh, vh, sk_actual)
    bn, sq_p, _ = qh.shape
    out = torch.empty_like(qh)
    if with_lse:
        lse = torch.empty((bn, sq_p), dtype=torch.float32, device=qh.device)
        _kernels.launch("flash_fwd_lse", "fg_flash_fwd_lse", qh.data_ptr(), kh.data_ptr(),
                        vh.data_ptr(), out.data_ptr(), lse.data_ptr(), bn, sq_p,
                        int(sk_actual), kh.shape[1])
        return out, lse
    _kernels.launch("flash_fwd", "fg_flash_fwd", qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    out.data_ptr(), bn, sq_p, int(sk_actual), kh.shape[1])
    return out


def flash_bwd_dq(qh, kh, vh, doh, lse, delta, *, sk_actual, dq_factor):
    """K6b: dQ (BN, Sq_pad, 128) from the forward's lse and delta."""
    if not qh.is_cuda:
        return flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta, sk_actual=sk_actual,
                                  dq_factor=dq_factor)
    _check_heads_major(qh, kh, vh, sk_actual, (("doh", doh),))
    if doh.shape != qh.shape:
        raise ValueError("doh must have q's shape")
    _check_rows(lse, "lse", qh.shape[:2])
    _check_rows(delta, "delta", qh.shape[:2])
    dq = torch.empty_like(qh)
    _kernels.launch("flash_bwd_dq", "fg_flash_bwd_dq", qh.data_ptr(), kh.data_ptr(),
                    vh.data_ptr(), doh.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), float(dq_factor), qh.shape[0], qh.shape[1],
                    int(sk_actual), kh.shape[1])
    return dq


def flash_bwd_dkv(qh, kh, vh, doh, lse, delta, *, sq, sk_actual):
    """K6c: (dK, dV), each (BN, Sk_pad, 128); queries >= sq are skipped."""
    if not qh.is_cuda:
        return flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk_actual)
    _check_heads_major(qh, kh, vh, sk_actual, (("doh", doh),))
    if doh.shape != qh.shape or not 1 <= sq <= qh.shape[1]:
        raise ValueError("doh must have q's shape and 1 <= sq <= Sq_pad")
    _check_rows(lse, "lse", qh.shape[:2])
    _check_rows(delta, "delta", qh.shape[:2])
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    _kernels.launch("flash_bwd_dkv", "fg_flash_bwd_dkv", qh.data_ptr(), kh.data_ptr(),
                    vh.data_ptr(), doh.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), qh.shape[0], int(sq), qh.shape[1],
                    int(sk_actual), kh.shape[1])
    return dk, dv


def _tiles(sq, sk, bq_default=DEFAULT_BQ):
    """The JAX package's tiles: bq = min(default, max(128, sq)), bk likewise."""
    return min(bq_default, max(128, sq)), min(DEFAULT_BK, max(128, sk))


def _pad_len(s, tile, cuda):
    """s rounded up to the tile; on the card also to the kernels' 64 rows."""
    n = -(-s // tile) * tile
    return -(-n // _ROW_TILE) * _ROW_TILE if cuda else n


def _heads_major(x, s_pad):
    """(B, S, N, d) -> zero-padded (B*N, s_pad, d), contiguous."""
    b, s, n, d = x.shape
    out = x.new_zeros((b * n, s_pad, d))
    out[:, :s] = x.permute(0, 2, 1, 3).reshape(b * n, s, d)
    return out


def _natural(xh, b, n, s):
    """(B*N, S_pad, d) -> (B, s, N, d)."""
    return xh[:, :s].reshape(b, n, s, xh.shape[-1]).permute(0, 2, 1, 3)


def _prescale(q, scale, prescaled):
    if prescaled:
        return q
    scale_val = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return (q.float() * (scale_val * LOG2E)).to(q.dtype)


def _layout(q, k, scale, prescaled, bq_default=DEFAULT_BQ):
    """Prescaled head-major q and head-major k, zero-padded to the tiles."""
    sq, sk = q.shape[1], k.shape[1]
    bq, bk = _tiles(sq, sk, bq_default)
    qh = _heads_major(_prescale(q, scale, prescaled), _pad_len(sq, bq, q.is_cuda))
    return qh, _heads_major(k, _pad_len(sk, bk, q.is_cuda))


def _flash_fwd_impl(q, k, v, scale=None, prescaled=False, kv_len=None, bounded_logits=False):
    """The no-gradient forward: with ``bounded_logits`` and no ``kv_len``,
    K4 when the keys fit one tile and K3 otherwise (pad-correction form, on
    zero-padded head-major q/k and natural v); every other call K5."""
    b, sq, n, _ = q.shape
    sk = k.shape[1]
    qh, kh = _layout(q, k, scale, prescaled, 2048 if bounded_logits else DEFAULT_BQ)
    sk_p = kh.shape[1]
    if bounded_logits and kv_len is None:
        # keys in one TPU k tile -> K4 (the wrapper picks it by sk_p == bk)
        k_tile = sk_p if sk <= DEFAULT_BK else DEFAULT_BK
        return flash_attention_heads_major(qh, kh, v.contiguous(), b=b, n=n, sq=sq,
                                           sk_actual=sk, bq=qh.shape[1], bk=k_tile)
    sk_act = sk if kv_len is None else int(kv_len)
    out = flash_fwd(qh, kh, _heads_major(v, sk_p), sk_actual=sk_act, with_lse=False)
    return _natural(out, b, n, sq)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: forward K6a (saves o and the
    per-row lse), backward K6b then K6c, δ = Σ dO·O in PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prescaled, kv_len):
        b, sq, n, d = q.shape
        sk = k.shape[1]
        qh, kh = _layout(q, k, scale, prescaled)
        vh = _heads_major(v, kh.shape[1])
        sk_act = sk if kv_len is None else int(kv_len)
        oh, lse = flash_fwd(qh, kh, vh, sk_actual=sk_act, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        scale_val = d ** -0.5 if scale is None else float(scale)
        ctx.meta = (b, sq, n, sk, sk_act, (1.0 / LOG2E) if prescaled else scale_val)
        return _natural(oh, b, n, sq)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        b, sq, n, sk, sk_act, dq_factor = ctx.meta
        doh = _heads_major(g.to(qh.dtype), qh.shape[1])
        delta = (doh.float() * oh.float()).sum(-1)
        dq = flash_bwd_dq(qh, kh, vh, doh, lse, delta, sk_actual=sk_act, dq_factor=dq_factor)
        dk, dv = flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk_act)
        return (_natural(dq, b, n, sq), _natural(dk, b, n, sk), _natural(dv, b, n, sk),
                None, None, None)


def flash_attention(q, k, v, scale=None, prescaled=False, kv_len=None, bounded_logits=False):
    """Flash attention, (B, S, N, d) in and out (port of the JAX package's
    ``flash_attention``).  ``prescaled``: q already carries scale·log2(e)
    (gradients are then w.r.t. that q).  ``kv_len``: only the first
    ``kv_len`` keys attend.  ``bounded_logits``: q/k are rms-normed, so the
    no-gradient forward may use the max-free K3/K4.  When a gradient is
    needed the forward is K6a and the backward K6b + K6c."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, prescaled, kv_len)
    return _flash_fwd_impl(q, k, v, scale, prescaled, kv_len, bounded_logits)
