"""Plain attention (port of fairygen_tpu/ops/attention.py ``xla_attention``).

Convention: q, k, v are (B, S, N, D), output (B, S, N, D).  This is the
plain path only; the DiT's attention goes through the hand-written kernels
of ``ops/flash_attention.py`` on CUDA.
"""
from __future__ import annotations

import torch

LOG2E = 1.4426950408889634


def attention(q, k, v, prescaled=False, bounded_logits=False):
    """fp32 softmax attention.

    ``prescaled``: q carries hd^-1/2·log2e (the DiT folds it into the q
    norm gamma), so logits are divided by log2e; otherwise they are scaled
    by hd^-1/2.  ``bounded_logits`` is accepted for signature parity with
    the JAX package: the plain softmax is exact either way."""
    del bounded_logits
    scale = 1.0 / LOG2E if prescaled else q.shape[-1] ** -0.5
    logits = torch.einsum("bsnd,btnd->bnst", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)
