"""The port's K7, K8 and K10 plain versions (what a CPU tensor runs), the
uniform ``ln_modulate`` and the image-DiT attention entries, against the JAX
package's Pallas kernels in interpret mode (as tests/test_fused_qk.py and
tests/test_flash_attention.py run them) with the TPU gates opened.

Inputs are made with numpy from a seed and handed to both packages; head
dim 128.  Tolerances:
  * fp32: 2e-5 absolute (1e-5 relative) — the two sides sum in other orders;
  * bf16 K7/K8: the norm part (identity tables) bit-equal; the rotated
    output within 2 bf16 ulps at the magnitude of the rotated pair, as K2's
    test allows (XLA on the CPU may contract the rotation).  K2's test feeds
    both sides one rms statistic; K7/K8 compute it inside, so here the
    inputs lie on a 2^-6 grid in [-2, 2], where every sum of squares is
    exact in fp32 whatever the order, and the norm part is bit-equal on
    every (row, head) whose fp32 rsqrt agrees between XLA and PyTorch —
    neither rounds rsqrt correctly, and they differ by an ulp on about half
    the rows — and within one bf16 ulp on the others;
  * bf16 K10: 2^-8 absolute — p is rounded to bf16 before p·v on both
    sides, against maxima taken over tiles of different sizes.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as jfn
import fairygen_tpu.ops.fused_qk as jfq
from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu_torch.ops import fused_qk as tfq
from fairygen_tpu_torch.ops.attention import attention, xla_attention
from fairygen_tpu_torch.ops.flash_attention import flash_attention_bias
from fairygen_tpu_torch.ops.fused_norms import ln_modulate
from fairygen_tpu_torch.ops.rope import apply_interleaved_rope

HD = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _tables(rng, rows):
    ang = rng.uniform(0, 6.28, (rows, HD // 2))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _as(dtype, *arrays):
    """numpy -> (jax arrays, torch tensors) holding the same values."""
    j = [jnp.asarray(a, dtype) for a in arrays]
    t = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16 if dtype == jnp.bfloat16
                                                  else torch.float32) for a in j]
    return j, t


def _grid(rng, shape):
    """Values k/64, |k| <= 128: exact in bf16, squares summed exactly in fp32."""
    return rng.integers(-128, 129, shape) / 64.0


def _same_statistic(xs, n, s_pads):
    """(B·N, sum(s_pads)) mask: the per-head fp32 rsqrt statistic is the
    same in XLA and PyTorch.  ``xs``: one (B, S, N·hd) array per segment of
    s_pads rows (rows past S are padding: True)."""
    import jax

    masks = []
    for x, s_pad in zip(xs, s_pads):
        b, s, d = x.shape
        xf = x.reshape(b, s, n, d // n).astype(np.float32)
        rj = np.asarray(jax.jit(lambda a: jax.lax.rsqrt(jnp.mean(a * a, -1) + 1e-6))(xf))
        rt = torch.rsqrt(torch.from_numpy(xf).pow(2).mean(-1) + 1e-6).numpy()
        m = np.ones((b, n, s_pad), bool)
        m[:, :, :s] = (rj == rt).transpose(0, 2, 1)
        masks.append(m.reshape(b * n, s_pad))
    return np.concatenate(masks, 1)


def _check_norm(out, ref, same):
    np.testing.assert_array_equal(out[same], ref[same])
    assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))


def _check_rotated(out, ref, norm_ref):
    """bf16: within 2 ulps of the rotated pair's magnitude."""
    pair = np.maximum(np.abs(norm_ref[..., 0::2]), np.abs(norm_ref[..., 1::2])).repeat(2, -1)
    assert np.all(np.abs(out - ref) <= 2 * _bf16_ulp(pair))


@pytest.mark.parametrize("s,dtype", [(300, jnp.float32), (1100, jnp.bfloat16)],
                         ids=["300-fp32", "1100-bf16"])
def test_k7_rms_rope_per_head_matches_pallas(dtype, s):
    n = 2
    rng = np.random.default_rng(s)
    cos, sin = _tables(rng, s)
    (xj, gj), (xt, gt) = _as(dtype, _grid(rng, (1, s, n * HD)),
                             rng.standard_normal(HD) * HD ** -0.5 * 1.4427)
    s_pad = tfq._pad_for_flash(s)[0]
    ident = (np.ones((s, HD // 2), np.float32), np.zeros((s, HD // 2), np.float32))
    refs, outs = [], []
    for c, sn in ((cos, sin), ident):
        with pltpu.force_tpu_interpret_mode():
            refs.append(_np(jfq.rms_rope_heads_major_per_head(
                xj, gj, jfq.build_freqs_full_pairs(jnp.asarray(c), jnp.asarray(sn)), n, s_pad,
                eps=1e-6)))
        outs.append(tfq.rms_rope_heads_major_per_head(
            xt, gt, tfq.build_freqs_full_pairs(_t(c), _t(sn)), n, s_pad, eps=1e-6).float().numpy())
    assert outs[0].shape == (n, s_pad, HD) and np.all(outs[0][:, s:] == 0)
    if dtype == jnp.float32:
        np.testing.assert_allclose(outs[0], refs[0], atol=2e-5, rtol=1e-5)
    else:
        _check_norm(outs[1], refs[1], _same_statistic([_np(xj)], n, [s_pad]))
        _check_rotated(outs[0], refs[0], refs[1])


@pytest.mark.parametrize("s_t,s_i,dtype", [(77, 300, jnp.bfloat16), (512, 1024, jnp.float32)],
                         ids=["77-300-bf16", "512-1024-fp32"])
def test_k8_rms_rope_joint_matches_pallas(dtype, s_t, s_i):
    n = 2
    rng = np.random.default_rng(s_t + s_i)
    i_pad = -(-s_i // 1024) * 1024
    s_pad = i_pad + -(-s_t // 1024) * 1024
    ci, si = _tables(rng, s_i)
    ct, st = _tables(rng, s_t)
    (xi, xt_, gi, gt_), (ti, tt, tgi, tgt) = _as(
        dtype, _grid(rng, (1, s_i, n * HD)), _grid(rng, (1, s_t, n * HD)),
        rng.standard_normal(HD), rng.standard_normal(HD))
    refs, outs = [], []
    for tabs in ((ci, si, ct, st),
                 (np.ones_like(ci), np.zeros_like(si), np.ones_like(ct), np.zeros_like(st))):
        jff = jfq.build_freqs_full_joint(*(jnp.asarray(a) for a in tabs), i_pad, s_pad)
        tff = tfq.build_freqs_full_joint(*(_t(a) for a in tabs), i_pad, s_pad)
        np.testing.assert_array_equal(tff.numpy(), np.asarray(jff))
        with pltpu.force_tpu_interpret_mode():
            refs.append(_np(jfq.rms_rope_heads_major_joint(xi, xt_, gi, gt_, jff, n, i_pad,
                                                           s_pad, eps=1e-6)))
        outs.append(tfq.rms_rope_heads_major_joint(ti, tt, tgi, tgt, tff, n, i_pad, s_pad,
                                                   eps=1e-6).float().numpy())
    out = outs[0]
    assert out.shape == (n, s_pad, HD)
    assert np.all(out[:, s_i:i_pad] == 0) and np.all(out[:, i_pad + s_t:] == 0)
    if dtype == jnp.float32:
        np.testing.assert_allclose(out, refs[0], atol=2e-5, rtol=1e-5)
    else:
        _check_norm(outs[1], refs[1],
                    _same_statistic([_np(xi), _np(xt_)], n, [i_pad, s_pad - i_pad]))
        _check_rotated(out, refs[0], refs[1])


def _eligen_like_bias(rng, b, sq, sk):
    allow = rng.random((b, sq, sk)) < 0.7
    allow[:, np.arange(min(sq, sk)), np.arange(min(sq, sk))] = True
    dense = 0.3 * rng.standard_normal((b, sq, sk))
    return np.where(allow, dense, -1e30).astype(np.float32)


@pytest.mark.parametrize("b,bias_b,sq,sk,dtype", [
    (1, 1, 300, 300, jnp.float32), (2, 1, 200, 333, jnp.bfloat16),
    (2, 2, 1100, 1100, jnp.float32), (2, 2, 1100, 1100, jnp.bfloat16)],
    ids=["300-fp32", "200x333-shared-bf16", "1100-fp32", "1100-bf16"])
def test_k10_flash_attention_bias_matches_pallas(dtype, b, bias_b, sq, sk):
    n = 2
    rng = np.random.default_rng(sq + sk)
    (q, k, v), (tq, tk, tv) = _as(dtype, rng.standard_normal((b, sq, n, HD)),
                                  rng.standard_normal((b, sk, n, HD)),
                                  rng.standard_normal((b, sk, n, HD)))
    bias = _eligen_like_bias(rng, bias_b, sq, sk)
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jfa.flash_attention_bias(q, k, v, jnp.asarray(bias)))
    out = flash_attention_bias(tq, tk, tv, _t(bias)).float().numpy()
    assert out.shape == (b, sq, n, HD)
    if dtype == jnp.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, atol=2 ** -8, rtol=0)


def test_k10_prescaled_and_attention_dispatch():
    """``prescaled`` q == the scale applied inside; on CPU tensors the
    attention entry sends any bias to the plain path, which agrees."""
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng.standard_normal((1, 150, 2, HD)).astype(np.float32)) for _ in range(3))
    bias = _t(_eligen_like_bias(rng, 1, 150, 150))
    ref = flash_attention_bias(q, k, v, bias)
    qs = q * (HD ** -0.5 * 1.4426950408889634)
    np.testing.assert_allclose(flash_attention_bias(qs, k, v, bias, prescaled=True).numpy(),
                               ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(attention(q, k, v, bias=bias[:, None]).numpy(), ref.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(xla_attention(q, k, v, bias=bias[:, None]).numpy(),
                               ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 300, 256), (2, 100, 256), (1, 300, 96)])
def test_uniform_ln_modulate_matches_jax(dtype, shape):
    """The kernel gate (D % 128 == 0, S >= 256) and the plain expression off
    it, against the JAX entry with its TPU gate open (interpret mode).
    fp32 2e-5; bf16 one bf16 ulp of the result (2^-7 relative)."""
    b, s, d = shape
    rng = np.random.default_rng(s + d)
    (x, sh, sc), (tx, tsh, tsc) = _as(dtype, rng.standard_normal(shape),
                                      0.3 * rng.standard_normal((b, 1, d)),
                                      0.3 * rng.standard_normal((b, 1, d)))
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(jfn, "_on_tpu", lambda: True):
        ref = _np(jfn.ln_modulate(x, sh, sc, 1e-6))
    out = ln_modulate(tx, tsh, tsc, 1e-6).float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=2 ** -7)


def test_interleaved_rope_matches_jax():
    from fairygen_tpu.ops.rope import apply_interleaved_rope as j_rope

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    cos, sin = (a[:, :8] for a in _tables(rng, 7))
    ref = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    np.testing.assert_array_equal(apply_interleaved_rope(_t(x), _t(cos), _t(sin)).numpy(), ref)


def _entry_inputs(rng, b, s, n):
    d = n * HD
    xq, xk = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, n, HD)).astype(np.float32)
    gq, gk = (1 + 0.1 * rng.standard_normal(HD).astype(np.float32) for _ in range(2))
    return xq, xk, v, gq, gk


@pytest.mark.parametrize("s,fold", [(1100, False)])
def test_per_head_entry_matches_pallas_entry(s, fold):
    """fused_qk_attention_per_head (K7 q, K7 k, K4 or K3) against the JAX
    entry with its TPU gate open, fp32."""
    rng = np.random.default_rng(5)
    args = _entry_inputs(rng, 1, s, 2)
    cos, sin = _tables(rng, s)
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(jfq, "_on_tpu", lambda: True):
        ref = jfq.fused_qk_attention_per_head(*(jnp.asarray(a) for a in args + (cos, sin)),
                                              2, 1e-6, fold)
    out = tfq.fused_qk_attention_per_head(*(_t(a) for a in args + (cos, sin)), 2, 1e-6, fold)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("s_t,s_i", [(256, 1100)])
def test_joint_entry_matches_pallas_entry(s_t, s_i):
    """fused_qk_attention_joint (K8 q, K8 k, K3 over the gapped buffer)
    against the JAX entry with its TPU gate open, fp32; outputs in (txt,
    img) order."""
    rng = np.random.default_rng(6)
    xq_t, xk_t, v_t, gq_t, gk_t = _entry_inputs(rng, 1, s_t, 2)
    xq_i, xk_i, v_i, gq_i, gk_i = _entry_inputs(rng, 1, s_i, 2)
    args = (xq_t, xk_t, v_t, xq_i, xk_i, v_i, gq_t, gk_t, gq_i, gk_i) + _tables(rng, s_t) + \
        _tables(rng, s_i)
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(jfq, "_on_tpu", lambda: True):
        ref = jfq.fused_qk_attention_joint(*(jnp.asarray(a) for a in args), 2, 1e-6, True)
    out = tfq.fused_qk_attention_joint(*(_t(a) for a in args), 2, 1e-6, True)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=1e-5)


def test_entry_gradients_match_the_plain_chain():
    """The per-head and joint entries' gradients == autograd of the plain
    chains (fp32, CPU)."""
    rng = np.random.default_rng(7)
    xq, xk, v, gq, gk = (_t(a).requires_grad_() for a in _entry_inputs(rng, 1, 40, 2))
    cos, sin = (_t(a) for a in _tables(rng, 40))
    w = _t(rng.standard_normal((1, 40, 2, HD)).astype(np.float32))
    ins = (xq, xk, v, gq, gk)
    g1 = torch.autograd.grad((tfq.fused_qk_attention_per_head(*ins, cos, sin, 2, 1e-6) * w).sum(),
                             ins)
    g2 = torch.autograd.grad((tfq._reference_chain_per_head(*ins, cos, sin, 2, 1e-6, True)
                              * w).sum(), ins)
    for a, r in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
    t_in = tuple(_t(a).requires_grad_() for a in _entry_inputs(rng, 1, 9, 2))
    tabs = tuple(_t(a) for a in _tables(rng, 9) + _tables(rng, 40))
    j_in = t_in[:3] + ins[:3] + (t_in[3], t_in[4], gq, gk)
    wt = _t(rng.standard_normal((1, 9, 2, HD)).astype(np.float32))

    def loss(o):
        return (o[0] * wt).sum() + (o[1] * w).sum()

    g1 = torch.autograd.grad(loss(tfq.fused_qk_attention_joint(*j_in, *tabs, 2, 1e-6)), j_in)
    g2 = torch.autograd.grad(loss(tfq._reference_chain_joint(*j_in, *tabs, 2, 1e-6, True)), j_in)
    for a, r in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
