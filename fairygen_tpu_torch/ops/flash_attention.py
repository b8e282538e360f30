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
