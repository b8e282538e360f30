"""Attention dispatch (port of fairygen_tpu/ops/attention.py).

Convention: q, k, v are (B, S, N, D), output (B, S, N, D).  CUDA tensors go
to the hand-written flash kernels of ``ops/flash_attention.py`` (as the JAX
package sends accelerator arrays to Pallas): a head-shared bias (B|1, 1,
Sq, Sk) without ``kv_len`` to K10, no bias to K3-K6; any other bias takes
the plain path, as the JAX package sends it to XLA.  CPU tensors take
:func:`xla_attention`, the plain fp32-softmax path.
"""
from __future__ import annotations

import torch

from .flash_attention import LOG2E, flash_attention, flash_attention_bias


def xla_attention(q, k, v, scale=None, prescaled=False, kv_len=None, bias=None):
    """fp32 softmax attention (the JAX package's ``xla_attention``).

    ``prescaled``: q carries hd^-1/2·log2e (the DiT folds it into the q
    norm gamma), so logits are divided by log2e; otherwise they are scaled
    by ``scale`` (default hd^-1/2).  ``kv_len``: keys past it are masked.
    ``bias``: an additive fp32 logits bias (B|1, N|1, S, T)."""
    if prescaled:
        scale = 1.0 / LOG2E
    elif scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bsnd,btnd->bnst", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if kv_len is not None and kv_len != k.shape[1]:
        col = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
        logits = torch.where(col < kv_len, logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def attention(q, k, v, scale=None, prescaled=False, kv_len=None, bias=None,
              bounded_logits=False):
    """Scaled dot-product attention, (B, S, N, D) in and out.

    ``bounded_logits``: q/k are rms-normed, so the no-gradient flash forward
    may skip the running max (ignored on the plain path, where the softmax
    is exact either way, and with a bias, whose K10 keeps the max).
    ``bias``: additive fp32 logits bias (B|1, N|1, Sq, Sk), natural log."""
    if q.is_cuda and bias is None:
        return flash_attention(q, k, v, scale=scale, prescaled=prescaled, kv_len=kv_len,
                               bounded_logits=bounded_logits)
    if q.is_cuda and kv_len is None and bias.dim() == 4 and bias.shape[1] == 1:
        return flash_attention_bias(q, k, v, bias[:, 0], scale=scale, prescaled=prescaled)
    return xla_attention(q, k, v, scale=scale, prescaled=prescaled, kv_len=kv_len, bias=bias)
