"""The rounding of the port's Hopper K5 (head dims 128 and SD1.5's 8, 40, 80
and 160) and K6a kernels (head dims 128 and, for the bf16 SDXL UNet's
gradient path, 64), emulated in
plain PyTorch, against the JAX package's forward attention in interpret
mode.

The CUDA kernels (``csrc/flash_attention_online.cu``) walk the keys in
128-key tiles with a running max m: p = exp2(s - m) is rounded to bf16
against the max of the tiles so far, l is summed in fp32 from the
unrounded p, o = O / l and lse = m + log2(l).  The JAX side rounds p
against the max of tiles of up to 1024 keys: K6a's reference is
``_flash_fwd`` (``_fa_fwd_lse_kernel``), K5's ``_flash_fwd_impl``, which
runs ``_fa_kernel`` at (1100, 1100) and, where the keys fit one k tile
((300, 300), (300, 77)), ``_fa_small_kv_kernel``'s max form: the same
arithmetic over that one tile.  Both sides take the same bf16 q/k/v
(numpy, from a seed).  The emulation is held to the card tests' bounds
(2^-7 relative + 2^-8 absolute on o, 1e-5 / 1e-4 on lse) and to a
relative L2 error of o below 2^-8, the bound ``chip_smoke.py`` also puts
on the kernels at the training shapes.  On these inputs its worst error
on o is about a third of the elementwise bound and its relative L2 error
about half of 2^-8; an emulation that dropped the last key tile at
(300, 300) or (1100, 1100) errs 40-100 times over the L2 bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.ops import flash_attention as jfa

D = 128
TILE = 128  # keys per tile of the CUDA kernels
BN = 2
O_REL_L2 = 2 ** -8


def online_tiles(qh, kh, vh, sk_actual):
    """The CUDA kernels' arithmetic on head-major bf16 (BN, S_pad, D): fp32
    scores, keys >= sk_actual at -inf, a running max over 128-key tiles, p
    rounded to bf16 before P V.  Returns o (bf16) and lse (fp32)."""
    q = qh.float()
    rows = q.shape[:2]
    m = torch.full(rows, float("-inf"))
    l = torch.zeros(rows)
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk_actual, TILE):
        s = q @ kh[:, k0:k0 + TILE].float().transpose(1, 2)
        s[..., sk_actual - k0:] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vh[:, k0:k0 + TILE].float()
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16), m + torch.log2(l)


def _inputs(sq, sk, seed, d=D):
    """bf16 q (prescaled by d^-1/2 log2 e), k, v of BN heads: head-major
    torch tensors (BN, S, d) and the same values in JAX as (1, S, BN, d)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(d ** -0.5 * 1.4426950408889634)
    arrays = [rng.standard_normal((BN, s, d)).astype(np.float32) * f
              for s, f in ((sq, scale), (sk, 1.0), (sk, 1.0))]
    heads = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    natural = [jnp.asarray(t.float().numpy().transpose(1, 0, 2)[None]).astype(jnp.bfloat16)
               for t in heads]
    return heads, natural


# (sq, sk, kv_len): three key tiles, the last one partial (44 of 128
# keys); one partial key tile (77 keys); a kv_len inside the ninth key
# tile over non-zero keys, and two Pallas k tiles
SHAPES = [(300, 300, None), (300, 77, None), (1100, 1100, 1050)]


@pytest.mark.parametrize("with_lse", [False, True], ids=["k5", "k6a"])
@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_128_key_tiles_match_pallas(sq, sk, kv_len, with_lse):
    _check_tiles(sq, sk, kv_len, with_lse, D)


@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_128_key_tiles_match_pallas_k6a_at_head_dim_64(sq, sk, kv_len):
    """K6a at head dim 64 (the bf16 SDXL UNet under a gradient) rounds as at
    128: the same 128-key tiles against Pallas's 1024-key ones, the same
    bounds (atol 2^-8 on o)."""
    _check_tiles(sq, sk, kv_len, True, 64)


@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("sq,sk,kv_len", SHAPES)
def test_128_key_tiles_match_pallas_k5_at_sd15_head_dims(sq, sk, kv_len, d):
    """K5 at SD1.5's head dims (8, 40, 80, 160; on the card the kernels of
    the next width up over zero columns past d) rounds as at 128: the same
    128-key tiles and running max, the same bounds on o."""
    _check_tiles(sq, sk, kv_len, False, d)


def _check_tiles(sq, sk, kv_len, with_lse, d):
    (tq, tk, tv), (jq, jk, jv) = _inputs(sq, sk, seed=sq + sk, d=d)
    o, lse = online_tiles(tq, tk, tv, sk if kv_len is None else kv_len)
    with pltpu.force_tpu_interpret_mode():
        if with_lse:
            ref_o, (_, _, _, _, ref_lse) = jfa._flash_fwd(jq, jk, jv, None, True, kv_len)
        else:
            ref_o = jfa._flash_fwd_impl(jq, jk, jv, prescaled=True, kv_len=kv_len)
    ref_o = torch.from_numpy(np.asarray(ref_o[0].astype(jnp.float32)).transpose(1, 0, 2).copy())
    torch.testing.assert_close(o.float(), ref_o, rtol=2 ** -7, atol=2 ** -8)
    rel_l2 = ((o.float() - ref_o).norm() / ref_o.norm()).item()
    assert rel_l2 < O_REL_L2, f"relative L2 error of o {rel_l2:.3e} (bound {O_REL_L2:.3e})"
    if with_lse:
        ref_lse = torch.from_numpy(np.asarray(ref_lse)[:, :sq, 0].copy())
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
