"""K4's max and masked forms and the generic entry's dispatch, at SDXL's head
dim 64 and at 128, against the JAX package: its Pallas kernel
``_fa_small_kv_kernel`` (bounded=False) runs in interpret mode, as
tests/test_flash_attention.py runs it, and the port's plain version is
what a CPU tensor takes.

Cases: SDXL's text cross-attention (77 keys padded to one k tile of 128:
the masked form), its 1024-token self-attention (one k tile, no mask: the
max form), and a caller's ``kv_len`` that cuts real, non-zero keys (the
masked form must mask them, not subtract them).  Inputs are made with
numpy from a seed, unit-variance.  Tolerances: fp32 2e-5 absolute (sums in
other orders); bf16 2^-8 absolute, one bf16 rounding of outputs below 1 in
magnitude (p is rounded to bf16 against the same row max on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu_torch.ops import flash_attention as tfa

CASES = [(200, 77, None), (130, 1024, None), (150, 300, 250)]


def _qkv(sq, sk, hd, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, n, hd)).astype(np.float32) for s in (sq, sk, sk)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,sk,kv_len", CASES)
def test_k4_max_and_masked_plain_match_pallas(sq, sk, kv_len, hd, dtype):
    q, k, v = _qkv(sq, sk, hd, seed=hd + sk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_fwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)), kv_len=kv_len)
    with torch.no_grad():
        out = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                  kv_len=kv_len)
    assert out.dtype == tdt and out.shape == (1, sq, 2, hd)
    atol = 2e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=1e-4 if dtype == "float32" else 0)


def test_masked_keys_need_not_be_zero():
    """With a kv_len the masked form masks the cut keys whatever they hold:
    the output equals attention over the first kv_len keys alone."""
    q, k, v = _qkv(64, 300, 64, seed=9)
    with torch.no_grad():
        out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=250)
        alone = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :250]),
                                    torch.from_numpy(v[:, :250]))
    torch.testing.assert_close(out, alone, rtol=1e-5, atol=2e-6)


def _jax_picks_k4(sk):
    """The JAX entry's branch: the padded keys are one k tile (sk_p == bk)."""
    bk = min(jfa.DEFAULT_BK, max(128, sk))
    return -(-sk // bk) * bk == bk


@pytest.mark.parametrize("sk,kv_len", [(77, None), (1024, None), (300, 250), (1025, None),
                                       (4096, None), (1100, 1050)])
def test_dispatch_picks_k4_when_the_keys_fit_one_k_tile(monkeypatch, sk, kv_len):
    """K4 (max or masked form) when the JAX entry's sk_p == bk, K5
    otherwise; the form (and so the launch counter on the card) follows the
    kernel's 64-row padding: masked when sk_actual < Sk_pad."""
    calls = []

    def spy(name):
        def fn(qh, kh, vh, *, sk_actual, **kw):
            calls.append((name, kh.shape[1], sk_actual))
            return torch.zeros_like(qh)
        return fn

    monkeypatch.setattr(tfa, "flash_small_kv_max", spy("K4"))
    monkeypatch.setattr(tfa, "flash_fwd", spy("K5"))
    q, k, v = (torch.zeros((1, s, 1, 64)) for s in (100, sk, sk))
    with torch.no_grad():
        tfa.flash_attention(q, k, v, kv_len=kv_len)
    (name, sk_pad, sk_actual), = calls
    assert (name == "K4") == _jax_picks_k4(sk)
    assert sk_actual == (sk if kv_len is None else kv_len)
    cuda_pad = tfa._pad_len(sk, tfa._tiles(100, sk)[1], True)
    if name == "K4":
        assert cuda_pad <= tfa.DEFAULT_BK
        assert (sk, cuda_pad, sk_actual < cuda_pad) in {
            (77, 128, True), (1024, 1024, False), (300, 320, True)}


def test_sdxl_calls_pick_the_forms_the_card_counts():
    """The three SDXL attention shapes at 1024x1024 (latent 128x128):
    4096-token self-attention -> K5, 1024-token self-attention -> K4 max
    form, 77 text keys -> K4 masked form (as the JAX entry: sk_p == bk, and
    masked since 77 < 128)."""
    assert not _jax_picks_k4(4096) and _jax_picks_k4(1024) and _jax_picks_k4(77)
    assert tfa._pad_len(1024, tfa._tiles(1024, 1024)[1], True) == 1024
    assert tfa._pad_len(77, tfa._tiles(4096, 77)[1], True) == 128


def test_one_1024_step_makes_10_k5_61_k4_max_70_k4_masked_calls(monkeypatch):
    """One BrushNet + UNet step of a 1024x1024 CFG request (latents 128 x
    128, batch 2, 77 text tokens), with the real block structure and token
    counts at narrow widths: the generic entry's dispatch sends 10
    self-attentions over 4096 tokens to K5, 60 over 1024 tokens plus
    BrushNet's mid attention to K4's max form, and the 70 cross-attentions
    to K4's masked form.  The kernels are replaced by spies that return
    zeros; chip_smoke.py holds the card to these counts."""
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl import unet2d as tunet

    calls = []

    def spy(fn_name):
        def fn(qh, kh, vh, *, sk_actual, **kw):
            form = fn_name if fn_name == "K5" else (
                "K4 masked" if sk_actual < kh.shape[1] else "K4 max")
            calls.append(form)
            return torch.zeros_like(qh)
        return fn

    monkeypatch.setattr(tfa, "flash_small_kv_max", spy("K4"))
    monkeypatch.setattr(tfa, "flash_fwd", spy("K5"))
    monkeypatch.setattr(tunet, "attention", lambda q, k, v: tfa.flash_attention(q, k, v))
    narrow = dict(block_out_channels=(32, 64, 128), num_attention_heads=(1, 2, 4),
                  cross_attention_dim=32)
    ucfg = tunet.UNet2DConfig(**narrow)
    bcfg = tunet.UNet2DConfig(**{**tunet.UNet2DConfig.brushnet_sdxl().__dict__, **narrow,
                                 "attention_head_dim": 32})
    unet = convert.init_unet2d_params(ucfg, "cpu", torch.float32)
    bn = convert.init_unet2d_params(bcfg, "cpu", torch.float32, brushnet=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 128, 128), generator=g)
    ehs = torch.randn((2, 77, 32), generator=g)
    kw = dict(text_embeds=torch.randn((2, 1280), generator=g),
              time_ids=torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2))
    t = torch.tensor(981.0)
    with torch.no_grad():
        down, mid, up = tunet.brushnet_forward(bn, bcfg, x, t, ehs,
                                               torch.randn((2, 5, 128, 128), generator=g),
                                               conditioning_scale=0.7, **kw)
        out = tunet.unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                                   mid_block_add_sample=mid, up_block_add_samples=up, **kw)
    assert out.shape == (2, 4, 128, 128)
    assert {f: calls.count(f) for f in set(calls)} == {"K5": 10, "K4 max": 61, "K4 masked": 70}
