"""The rounding of the port's Hopper K4 kernels (max and masked forms, at
head dims 64 and 128 and SD1.5's 8, 40, 80 and 160), emulated in plain
PyTorch, against the JAX package's forward attention in interpret mode.

The CUDA kernels (``csrc/flash_attention_online.cu``) walk the keys in
128-key tiles: over more than one tile a pre-pass finds each row's max m
over every key (keys >= sk_actual masked), then p = exp2(s - m) is rounded
to bf16 tile by tile, l and P V are summed tile by tile in fp32 from the
unrounded and the rounded p, and o = O / l is rounded once to bf16; over
one tile (K5's kernel) that tile's max is m.  The JAX side is
``_flash_fwd_impl``, which runs ``_fa_small_kv_kernel`` (``bounded=False``)
on one k tile of up to 1024 keys: the same row max, one sum over all keys.
Both sides take the same bf16 q/k/v (numpy, from a seed).  The emulation
is held to K4's card tolerance (2^-7 relative + 1e-3 absolute) and to a
relative L2 error of o below 2^-10.  The elementwise tolerance alone would
also pass p rounded against a running max (K5's rounding); the L2 bound
does not, at 1024 keys, and the last test shows it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.ops import flash_attention as jfa

TILE = 128  # keys per tile of the CUDA kernels
BN = 2
O_REL_L2 = 2 ** -10


def tiled_attention(qh, kh, vh, sk_actual, row_max=True):
    """Attention on head-major bf16 (BN, S, d) over 128-key tiles: fp32
    scores, keys >= sk_actual at -inf, p = exp2(s - m) rounded to bf16
    before P V, l and O summed tile by tile, one bf16 rounding of O / l.
    m is each row's max over every key (``row_max``, K4's kernels) or the
    max of the tiles so far (a running max, K5's).  Returns o (bf16)."""
    q = qh.float()
    scores = []
    for k0 in range(0, sk_actual, TILE):
        s = q @ kh[:, k0:k0 + TILE].float().transpose(1, 2)
        s[..., sk_actual - k0:] = float("-inf")
        scores.append((k0, s))
    m = torch.full(q.shape[:2], float("-inf"))
    if row_max:
        for _, s in scores:
            m = torch.maximum(m, s.amax(-1))
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    for k0, s in scores:
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vh[:, k0:k0 + TILE].float()
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16)


def _inputs(sq, sk, d, seed):
    """bf16 q (prescaled by d^-1/2 log2 e), k, v of BN heads, every row
    non-zero: head-major torch tensors (BN, S, d) and the same values in
    JAX as (1, S, BN, d)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(d ** -0.5 * 1.4426950408889634)
    arrays = [rng.standard_normal((BN, s, d)).astype(np.float32) * f
              for s, f in ((sq, scale), (sk, 1.0), (sk, 1.0))]
    heads = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    natural = [jnp.asarray(t.float().numpy().transpose(1, 0, 2)[None]).astype(jnp.bfloat16)
               for t in heads]
    return heads, natural


def _pallas(natural, kv_len):
    jq, jk, jv = natural
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_fwd_impl(jq, jk, jv, prescaled=True, kv_len=kv_len)
    return torch.from_numpy(np.asarray(ref[0].astype(jnp.float32)).transpose(1, 0, 2).copy())


def _rel_l2(o, ref):
    return ((o.float() - ref).norm() / ref.norm()).item()


# (sq, sk, kv_len): one partial key tile (the SDXL cross-attention's 77
# keys); eight tiles (SDXL's 1024-token self-attention); a kv_len of 250
# of 320 over non-zero cut rows (two tiles, the masked form); 192 keys,
# the max form with a partial second tile
SHAPES = [(300, 77, None), (256, 1024, None), (320, 320, 250), (128, 192, None)]


# head dims: SDXL's 64 and the Wan DiTs' 128, then SD1.5's 8 (BrushNet's mid
# attention), 40, 80 and 160, which the card computes in the kernels of the
# next width up over boxes whose columns past d are zeros
DIMS = [64, 128, 8, 40, 80, 160]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_row_max_tiles_match_pallas(sq, sk, kv_len, d):
    (tq, tk, tv), natural = _inputs(sq, sk, d, seed=sq + sk + d)
    o = tiled_attention(tq, tk, tv, sk if kv_len is None else kv_len)
    ref = _pallas(natural, kv_len)
    torch.testing.assert_close(o.float(), ref, rtol=2 ** -7, atol=1e-3)
    rel_l2 = _rel_l2(o, ref)
    assert rel_l2 < O_REL_L2, f"relative L2 error of o {rel_l2:.3e} (bound {O_REL_L2:.3e})"


@pytest.mark.parametrize("d", DIMS)
def test_l2_bound_rejects_a_running_max(d):
    """At 1024 keys p rounded against a running max passes the elementwise
    tolerance but not the L2 bound: the bound tells K4's rounding from
    K5's."""
    (tq, tk, tv), natural = _inputs(256, 1024, d, seed=256 + 1024 + d)
    ref = _pallas(natural, None)
    running = tiled_attention(tq, tk, tv, 1024, row_max=False)
    torch.testing.assert_close(running.float(), ref, rtol=2 ** -7, atol=1e-3)
    assert _rel_l2(running, ref) > O_REL_L2
    assert _rel_l2(tiled_attention(tq, tk, tv, 1024), ref) < O_REL_L2
