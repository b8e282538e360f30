"""The port's K5/K6a/K6b/K6c plain versions (what a CPU tensor runs) and the
gradients of its attention entries against the JAX package: its Pallas
kernels run in interpret mode, as tests/test_flash_attention.py runs them,
and its custom VJPs on the CPU.

Inputs are made with numpy from a seed and handed to both packages, fp32,
head dim 128.  Tolerances:
  * forward output and LSE: atol 2e-5, rtol 1e-4 — sums in other orders;
  * flash-attention gradients: atol 5e-4, rtol 1e-3, the JAX suite's own
    bound for its backward kernels;
  * gradients of the fused entries: atol 2e-5, rtol 1e-4 — both sides
    differentiate the same plain chain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as jfn
import fairygen_tpu.ops.fused_qk as jfq
from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu.ops.rope import build_freqs_grid as j_build_freqs_grid
from fairygen_tpu.ops.rope import precompute_freqs_3d as j_precompute_freqs_3d
from fairygen_tpu_torch.ops import flash_attention as tfa
from fairygen_tpu_torch.ops import fused_qk as tfq
from fairygen_tpu_torch.ops.fused_norms import layer_norm_modulate
from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

HD = 128


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _qkvw(sq, sk, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, n, HD)).astype(np.float32)
    k = rng.standard_normal((1, sk, n, HD)).astype(np.float32)
    v = rng.standard_normal((1, sk, n, HD)).astype(np.float32)
    w = rng.standard_normal((1, sq, n, HD)).astype(np.float32)
    return q, k, v, w


# (sq, sk, kv_len): self-attention with a ragged kv_len, text cross-attention
# (one k tile), and two k tiles with the mask in the second
SHAPES = [(300, 300, 250), (200, 77, None), (130, 1100, 1050)]


@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_k5_plain_matches_pallas(sq, sk, kv_len):
    q, k, v, _ = _qkvw(sq, sk, 2, seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  kv_len=kv_len)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_k6a_plain_output_and_lse_match_pallas(sq, sk, kv_len):
    q, k, v, _ = _qkvw(sq, sk, 2, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref_o, (_, _, _, _, ref_lse) = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), None, False, kv_len)
    bq, bk = tfa._tiles(sq, sk)
    qh = tfa._heads_major(tfa._prescale(_t(q), None, False), tfa._pad_len(sq, bq, False))
    kh, vh = (tfa._heads_major(_t(a), tfa._pad_len(sk, bk, False)) for a in (k, v))
    oh, lse = tfa.flash_fwd(qh, kh, vh, sk_actual=sk if kv_len is None else kv_len)
    np.testing.assert_allclose(tfa._natural(oh, 1, 2, sq).numpy(), np.asarray(ref_o),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse[:, :sq].numpy(), np.asarray(ref_lse)[:, :sq, 0],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
@pytest.mark.parametrize("prescaled", [True, False])
def test_k6b_k6c_gradients_match_pallas(sq, sk, kv_len, prescaled):
    """Gradients of the port's flash_attention (plain K6a/K6b/K6c) against
    jax.grad of the JAX flash_attention (Pallas kernels, interpret mode)."""
    q, k, v, w = _qkvw(sq, sk, 2, seed=2)
    if prescaled:
        q = q * np.float32(HD ** -0.5 * 1.4426950408889634)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, None, prescaled, kv_len, False)
        return jnp.sum(o * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq, tk, tv, prescaled=prescaled, kv_len=kv_len)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)


def test_padded_query_rows_add_nothing_to_dk_dv():
    """A ragged Sq: the head-major dO carries nonzero rows past sq, and K6c's
    plain version still gives the gradients of the sq real rows only."""
    sq, sk = 150, 90
    q, k, v, w = _qkvw(sq, sk, 1, seed=3)
    bq, bk = tfa._tiles(sq, sk)
    qh = tfa._heads_major(_t(q), tfa._pad_len(sq, bq, False))
    kh, vh = (tfa._heads_major(_t(a), tfa._pad_len(sk, bk, False)) for a in (k, v))
    doh = tfa._heads_major(_t(w), qh.shape[1])
    oh, lse = tfa.flash_fwd(qh, kh, vh, sk_actual=sk)
    delta = (doh * oh).sum(-1)
    dk, dv = tfa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk)
    doh[:, sq:] = 7.0  # garbage past the real rows
    dk2, dv2 = tfa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=sk)
    torch.testing.assert_close(dk2, dk, rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)
    assert torch.all(dk[:, sk:] == 0) and torch.all(dv[:, sk:] == 0)


@pytest.mark.parametrize("seg", [0, 37])
def test_layer_norm_modulate_gradient_matches_jax_vjp(seg):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 90, 256)).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 2, 256)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(jfn.layer_norm_modulate(a, b, c, seg, 1e-6) * w),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc))
    ins = [_t(a, True) for a in (x, sh, sc)]
    out = layer_norm_modulate(*ins, seg, 1e-6)
    grads = torch.autograd.grad((out * _t(w)).sum(), ins)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


def test_fused_qk_attention_gradient_matches_jax_vjp():
    b, s, n, grid = 1, 120, 2, (2, 6, 10)
    rng = np.random.default_rng(5)
    d = n * HD
    xq, xk = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, n, HD)).astype(np.float32)
    gq = (rng.standard_normal(d) * HD ** -0.5 * 1.4427).astype(np.float32)
    gk = rng.standard_normal(d).astype(np.float32)
    w = rng.standard_normal((b, s, n, HD)).astype(np.float32)
    jfreqs = j_build_freqs_grid(j_precompute_freqs_3d(HD, 128), *grid)
    jff = jfq.build_freqs_full(jfreqs)

    def jloss(*a):
        return jnp.sum(jfq.fused_qk_attention(*a, jfreqs, jff, n, 1e-6) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (xq, xk, v, gq, gk)))
    ff = tfq.build_freqs_full(build_freqs_grid(precompute_freqs_3d(HD, 128), *grid))
    ins = [_t(a, True) for a in (xq, xk, v, gq, gk)]
    out = tfq.fused_qk_attention(*ins, ff, n, 1e-6)
    grads = torch.autograd.grad((out * _t(w)).sum(), ins)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


def test_fused_q_attention_gradient_matches_jax_vjp():
    b, s, n, lk = 1, 100, 2, 40
    rng = np.random.default_rng(6)
    d = n * HD
    xq = rng.standard_normal((b, s, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, n, HD)).astype(np.float32)
    k = k / np.sqrt((k * k).mean(-1, keepdims=True))
    v = rng.standard_normal((b, lk, n, HD)).astype(np.float32)
    gq = (rng.standard_normal(d) * HD ** -0.5 * 1.4427).astype(np.float32)
    w = rng.standard_normal((b, s, n, HD)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jfq.fused_q_attention(*a, n, 1e-6) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (xq, k, v, gq)))
    ins = [_t(a, True) for a in (xq, k, v, gq)]
    out = tfq.fused_q_attention(*ins, n, 1e-6)
    grads = torch.autograd.grad((out * _t(w)).sum(), ins)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


def test_pair_freqs_recover_the_rope_tables():
    f = build_freqs_grid(precompute_freqs_3d(HD, 128), 2, 3, 4)
    torch.testing.assert_close(tfq._pair_freqs(tfq.build_freqs_full(f)), f, rtol=0, atol=0)
