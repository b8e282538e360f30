"""The port's K1-K4 plain versions (what a CPU tensor runs) against the JAX
package's Pallas kernels run in interpret mode, as tests/test_fused_norms.py,
tests/test_fused_qk.py and tests/test_flash_attention.py run them.

Inputs are made with numpy from a seed and handed to both packages.  head
dim 128 everywhere (the JAX fused entries gate on it).  Tolerances:
  * fp32: 2e-5 absolute — the two sides sum in different orders;
  * bf16 RoPE prep: the norm part is bit-identical; the rotated output
    agrees to 2 bf16 ulps at the magnitude of the rotated pair — XLA on the
    CPU may contract and keep excess precision in the rotation
    (ops/fused_qk.py:22-26 in the JAX package), and a rotation that nearly
    cancels turns that into a difference at the pair's scale, not the
    result's.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_qk as jfq
from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu.ops.fused_norms import _ln_mod_pallas
from fairygen_tpu.ops.rope import build_freqs_grid as j_build_freqs_grid
from fairygen_tpu.ops.rope import precompute_freqs_3d as j_precompute_freqs_3d
from fairygen_tpu_torch.ops import fused_qk as tfq
from fairygen_tpu_torch.ops.flash_attention import flash_attention_heads_major
from fairygen_tpu_torch.ops.fused_norms import layer_norm_modulate
from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

HD = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


@pytest.mark.parametrize("shape,seg", [((1, 300, 256), 0), ((2, 700, 128), 256),
                                       ((1, 512, 384), 113)])
def test_k1_ln_modulate_matches_pallas(shape, seg):
    b, s, d = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    sh = rng.standard_normal((b, 2, d)).astype(np.float32)
    sc = rng.standard_normal((b, 2, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_ln_mod_pallas(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc),
                                        seg, 1e-6))
    out = layer_norm_modulate(_t(x), _t(sh), _t(sc), seg, 1e-6).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def _prep_inputs(s, n, grid, seed):
    rng = np.random.default_rng(seed)
    d = n * HD
    x = rng.standard_normal((1, s, d)).astype(np.float32)
    gamma = (rng.standard_normal(d) * HD ** -0.5 * 1.4427).astype(np.float32)
    jfreqs = j_build_freqs_grid(j_precompute_freqs_3d(HD, 128), *grid)
    tfreqs = build_freqs_grid(precompute_freqs_3d(HD, 128), *grid)
    np.testing.assert_array_equal(np.asarray(jfreqs), tfreqs.numpy())
    return x, gamma, jfreqs, tfreqs


@pytest.mark.parametrize("s,grid", [(300, (5, 6, 10)), (1100, (11, 10, 10))])
def test_k2_rms_rope_matches_pallas(s, grid):
    n = 2
    x, gamma, jfreqs, tfreqs = _prep_inputs(s, n, grid, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    gj = jnp.asarray(gamma, jnp.bfloat16)
    s_pad, _, _ = jfq._pad_for_flash(s)
    assert tfq._pad_for_flash(s) == jfq._pad_for_flash(s)
    rsj = jfq._rowscale(xj, 1e-6)
    with pltpu.force_tpu_interpret_mode():
        ref = jfq.rms_rope_heads_major(xj, gj, rsj, jfq.build_freqs_full(jfreqs), n, s_pad)
        ref_n = jfq.rms_rope_heads_major(xj, gj, rsj, None, n, s_pad, rope=False)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_n = np.asarray(ref_n.astype(jnp.float32))

    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    gt = _t(np.asarray(gj.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_allclose(tfq._rowscale(xt, 1e-6).numpy(), np.asarray(rsj), rtol=1e-6)
    # the same statistic into both kernels: a last-bit difference in it
    # could flip a bf16 rounding of x·rowscale and blur the comparison
    rst = _t(np.array(rsj))
    out = tfq.rms_rope_heads_major(xt, gt, rst, tfq.build_freqs_full(tfreqs), n, s_pad)
    out_n = tfq.rms_rope_heads_major(xt, gt, rst, None, n, s_pad, rope=False)
    out, out_n = out.float().numpy(), out_n.float().numpy()

    assert out.shape == ref.shape == (n, s_pad, HD)
    np.testing.assert_array_equal(out_n, ref_n)
    pair = np.maximum(np.abs(ref_n[..., 0::2]), np.abs(ref_n[..., 1::2])).repeat(2, -1)
    assert np.all(np.abs(out - ref) <= 2 * _bf16_ulp(pair))
    assert np.all(out[:, s:] == 0)


def _qkv(b, n, sq, sk, seed):
    """rms-normed, prescaled head-major q and k (zero pad rows), natural v."""
    rng = np.random.default_rng(seed)

    def normed(rows):
        a = rng.standard_normal((b * n, rows, HD)).astype(np.float32)
        return a / np.sqrt((a * a).mean(-1, keepdims=True))

    q = normed(sq) * np.float32(HD ** -0.5 * 1.4426950408889634)
    k = normed(sk)
    v = rng.standard_normal((b, sk, n, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "sq,sk,sk_pad,bq,bk,kernel",
    [
        (300, 300, 1024, 1024, 1024, "K4"),     # self-attn, one k tile
        (1100, 1100, 2048, 2048, 1024, "K3"),   # self-attn, two k tiles
        (300, 77, 128, 1024, 128, "K4"),        # text cross-attn, ragged Lk
        (1950, 512, 512, 2048, 512, "K4"),      # cross-attn at the smoke length
    ],
)
def test_k3_k4_attention_matches_pallas(sq, sk, sk_pad, bq, bk, kernel):
    b, n = 1, 2
    sq_pad = jfq._pad_for_flash(sq)[0]
    q, k, v = _qkv(b, n, sq, sk, seed=2)
    qh = np.zeros((b * n, sq_pad, HD), np.float32)
    qh[:, :sq] = q
    kh = np.zeros((b * n, sk_pad, HD), np.float32)
    kh[:, :sk] = k
    with pltpu.force_tpu_interpret_mode():
        ref = jfa.flash_attention_heads_major(
            jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(v), b=b, n=n, sq=sq,
            sk_actual=sk, bq=bq, bk=bk, natural_out=True)
    out = flash_attention_heads_major(_t(qh), _t(kh), _t(v), b=b, n=n, sq=sq,
                                      sk_actual=sk, bq=bq, bk=bk)
    assert (kernel == "K4") == (sk_pad == bk)
    assert out.shape == (b, sq, n, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_fused_self_attention_matches_pallas_entry():
    """fused_qk_attention (K2 q, K2 k, K3) end to end against the JAX fused
    forward in interpret mode (fp32, so both sides see the same values)."""
    b, s, n, grid = 1, 1100, 2, (11, 10, 10)
    rng = np.random.default_rng(3)
    d = n * HD
    xq, xk = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, n, HD)).astype(np.float32)
    gq = (rng.standard_normal(d) * HD ** -0.5 * 1.4427).astype(np.float32)
    gk = rng.standard_normal(d).astype(np.float32)
    jfreqs = j_build_freqs_grid(j_precompute_freqs_3d(HD, 128), *grid)
    with pltpu.force_tpu_interpret_mode():
        ref = jfq._fused_fwd(*(jnp.asarray(a) for a in (xq, xk, v, gq, gk)),
                             jfq.build_freqs_full(jfreqs), n, 1e-6)
    tfreqs = build_freqs_grid(precompute_freqs_3d(HD, 128), *grid)
    out = tfq.fused_qk_attention(_t(xq), _t(xk), _t(v), _t(gq), _t(gk),
                                 tfq.build_freqs_full(tfreqs), n, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_fused_cross_attention_matches_pallas_entry():
    """fused_q_attention (K2 rope=False, K4) against the JAX entry with its
    TPU gate open, in interpret mode."""
    b, s, n, lk = 1, 300, 2, 77
    rng = np.random.default_rng(4)
    d = n * HD
    xq = rng.standard_normal((b, s, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, n, HD)).astype(np.float32)
    k = k / np.sqrt((k * k).mean(-1, keepdims=True))
    v = rng.standard_normal((b, lk, n, HD)).astype(np.float32)
    gq = (rng.standard_normal(d) * HD ** -0.5 * 1.4427).astype(np.float32)
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(jfq, "_on_tpu", lambda: True):
        ref = jfq.fused_q_attention(jnp.asarray(xq), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(gq), n, 1e-6)
    out = tfq.fused_q_attention(_t(xq), _t(k), _t(v), _t(gq), n, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
