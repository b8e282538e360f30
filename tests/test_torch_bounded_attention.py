"""The bounded attention's contract at its call sites (CPU, tiny sizes).

K3 and K4 (``flash_attention_heads_major``) stop their key loop at Lv, v's
row count, rounded up to their 128-key tile, and remove every zero key they
computed by the count correction ``l -= keys computed - sk_actual``.  That is
exact only if every key row at or past Lv is zero, so each call site of the
DiTs and the generic entry is driven here with a spy that checks the rows
it hands over: self-attention (``fused_qk_attention``), cross attention
(``fused_q_attention``), the per-head form (``fused_qk_attention_per_head``),
FLUX.1's joint layout with a zero gap longer than one key tile
(``fused_qk_attention_joint``) and ``flash_attention(...,
bounded_logits=True)``.
"""
import numpy as np
import pytest
import torch

from fairygen_tpu_torch.ops import flash_attention as fa
from fairygen_tpu_torch.ops import fused_qk as fq
from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

B, N, HD = 2, 2, 128


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _pairs(rng, s):
    ang = torch.from_numpy(rng.uniform(0, 6.283, (s, HD // 2)).astype(np.float32))
    return torch.cos(ang), torch.sin(ang)


def _self(rng):
    ff = fq.build_freqs_full(build_freqs_grid(precompute_freqs_3d(HD), 3, 4, 5))
    s = 60
    return fq.fused_qk_attention(_t(rng, B, s, N * HD), _t(rng, B, s, N * HD),
                                 _t(rng, B, s, N, HD), _t(rng, N * HD, scale=0.13),
                                 _t(rng, N * HD), ff, N, 1e-6)


def _cross(rng):
    k = _t(rng, B, 77, N, HD)
    k = k * torch.rsqrt(k.pow(2).mean(-1, keepdim=True) + 1e-6)
    return fq.fused_q_attention(_t(rng, B, 90, N * HD), k, _t(rng, B, 77, N, HD),
                                _t(rng, N * HD, scale=0.13), N, 1e-6)


def _per_head(rng):
    s = 70
    return fq.fused_qk_attention_per_head(_t(rng, B, s, N * HD), _t(rng, B, s, N * HD),
                                          _t(rng, B, s, N, HD), _t(rng, HD), _t(rng, HD),
                                          *_pairs(rng, s), N, 1e-6)


def _joint(rng):
    s_t, s_i = 30, 100  # the image rows pad to 1024: a zero gap of 924 keys
    return fq.fused_qk_attention_joint(
        _t(rng, B, s_t, N * HD), _t(rng, B, s_t, N * HD), _t(rng, B, s_t, N, HD),
        _t(rng, B, s_i, N * HD), _t(rng, B, s_i, N * HD), _t(rng, B, s_i, N, HD),
        _t(rng, HD), _t(rng, HD), _t(rng, HD), _t(rng, HD), *_pairs(rng, s_t),
        *_pairs(rng, s_i), N, 1e-6)


def _generic(rng):
    q, k = _t(rng, B, 150, N, HD), _t(rng, B, 210, N, HD)
    q, k = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) for x in (q, k))
    return fa.flash_attention(q, k, _t(rng, B, 210, N, HD), bounded_logits=True)


@pytest.mark.parametrize("site", [_self, _cross, _per_head, _joint, _generic],
                         ids=["fused_qk", "fused_q", "per_head", "joint", "generic"])
def test_key_rows_past_lv_are_zero_at_every_call_site(monkeypatch, site):
    real = fa.flash_attention_heads_major
    seen = []

    def spy(qh, kh, v, *, b, n, sq, sk_actual, **kw):
        lv = v.shape[1]
        seen.append((kh.shape[1], lv, sk_actual))
        assert v.shape[0] == b and v.shape[2] == n and kh.shape[0] == b * n
        assert 1 <= sk_actual <= lv <= kh.shape[1]
        assert torch.all(kh[:, lv:] == 0), "a non-zero key row at or past Lv"
        assert bool((kh[:, :sk_actual] != 0).any(-1).any())
        return real(qh, kh, v, b=b, n=n, sq=sq, sk_actual=sk_actual, **kw)

    monkeypatch.setattr(fa, "flash_attention_heads_major", spy)
    monkeypatch.setattr(fq, "flash_attention_heads_major", spy)
    with torch.no_grad():
        out = site(np.random.default_rng(5))
    assert len(seen) == 1
    for o in out if isinstance(out, tuple) else (out,):
        assert torch.isfinite(o).all()
