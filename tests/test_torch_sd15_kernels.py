"""K4's max and masked forms and K5 at SD1.5's head dims (8: BrushNet's mid
attention; 40, 80, 160: the UNet's 320, 640 and 1280 channels over 8
heads) against the JAX package, and the generic entry's dispatch at the
shapes of an SD1.5 + BrushNet step.

The JAX side's Pallas kernels (``_fa_kernel``, ``_fa_small_kv_kernel`` with
``bounded=False``) run in interpret mode, as tests/test_flash_attention.py
runs them; the port's plain versions are what a CPU tensor takes.  Inputs
are made with numpy from a seed, unit-variance, in bf16.  Tolerance: 2^-8
absolute, one bf16 rounding of outputs below 1 in magnitude (K4 rounds p
against the same row max on both sides; K5's plain version takes each row's
max over every key, the Pallas kernel over its 1024-key tiles).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu_torch.ops import _kernels
from fairygen_tpu_torch.ops import flash_attention as tfa

DIMS = (8, 40, 80, 160)
# form: (sq, sk, kv_len) -- K5 over keys past one k tile, K4's max form over
# 256 keys (two of the card's 128-key tiles), its masked form over the 77
# text keys padded to 128
FORMS = {"K5": (192, 1100, None), "K4 max": (320, 256, None), "K4 masked": (256, 77, None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests, restored after: its
    models are tiny, and under the suite's six workers on one machine
    torch's thread pools contend with each other and slow the file down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(sq, sk, d, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, n, d)).astype(np.float32) for s in (sq, sk, sk)]


def _jax_picks_k4(sk):
    """The JAX entry's branch: the padded keys are one k tile (sk_p == bk)."""
    bk = min(jfa.DEFAULT_BK, max(128, sk))
    return -(-sk // bk) * bk == bk


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_forms_match_pallas(form, d):
    sq, sk, kv_len = FORMS[form]
    assert _jax_picks_k4(sk) == (form != "K5")
    q, k, v = _qkv(sq, sk, d, seed=d + sk)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_fwd_impl(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  kv_len=kv_len)
    with torch.no_grad():
        out = tfa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                  kv_len=kv_len)
    assert out.dtype == torch.bfloat16 and out.shape == (1, sq, 2, d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2 ** -8, rtol=0)


def _card_form(kernel, sq, sk_actual, d):
    """The counter the card's wrapper counts a call under: K4's form follows
    the kernels' padding of the keys to a multiple of 64 (144 keys: 192,
    the masked form; the CPU path pads to the tile alone)."""
    if kernel == "flash_fwd":
        return tfa._dim_counter("flash_fwd", d)
    card_pad = tfa._pad_len(sk_actual, tfa._tiles(sq, sk_actual)[1], True)
    masked = sk_actual < card_pad
    return tfa._dim_counter("flash_small_kv_masked" if masked else "flash_small_kv_max", d)


def _spies(monkeypatch, calls):
    def spy(kernel):
        def fn(qh, kh, vh, *, sk_actual, **kw):
            calls.append(_card_form(kernel, qh.shape[1], sk_actual, qh.shape[-1]))
            return torch.zeros_like(qh)
        return fn

    monkeypatch.setattr(tfa, "flash_small_kv_max", spy("K4"))
    monkeypatch.setattr(tfa, "flash_fwd", spy("flash_fwd"))


# the counters of one SD1.5 + BrushNet step of a 512x512 request at CFG batch 2
SD15_PER_STEP = {"flash_fwd_d40": 5, "flash_small_kv_max_d80": 5, "flash_small_kv_max_d160": 5,
                 "flash_small_kv_masked_d40": 5, "flash_small_kv_masked_d80": 5,
                 "flash_small_kv_masked_d160": 7, "flash_small_kv_masked_d8": 1}


def test_one_512_step_makes_5_k5_10_k4_max_18_k4_masked_calls(monkeypatch):
    """One BrushNet + UNet step of a 512x512 CFG request (64 x 64 latents):
    the real block structure at the full model's head dims and token counts
    (channels 40, 80, 160, 160 at one head a level, 8 norm groups; BrushNet's
    mid attention at head dim 8 over 20 heads), the kernels replaced by
    spies that return zeros.  The five transformer blocks at 64 x 64
    self-attend through K5 at d 40, the five at 32 x 32 (1024 tokens) and
    the five at 16 x 16 (256) through K4's max form at d 80 and 160; every
    cross-attention to the 77 text keys, the mid block's self-attention over
    64 tokens and BrushNet's mid attention through K4's masked form: 5 / 10
    / 18 calls, each named by the counter the card's wrapper counts it
    under; chip_smoke.py holds the card to these counts."""
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl import unet2d as tunet

    calls = []
    _spies(monkeypatch, calls)
    monkeypatch.setattr(tunet, "attention", lambda q, k, v: tfa.flash_attention(q, k, v))
    narrow = dict(block_out_channels=(40, 80, 160, 160), num_attention_heads=(1, 1, 1, 1),
                  cross_attention_dim=32, norm_num_groups=8)
    ucfg = tunet.UNet2DConfig(**{**tunet.UNet2DConfig.sd15_base().__dict__, **narrow})
    bcfg = tunet.UNet2DConfig(**{**tunet.UNet2DConfig.brushnet_sd15().__dict__, **narrow})
    unet = convert.init_unet2d_params(ucfg, "cpu", torch.float32)
    bn = convert.init_unet2d_params(bcfg, "cpu", torch.float32, brushnet=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 64, 64), generator=g)
    ehs = torch.randn((2, 77, 32), generator=g)
    t = torch.tensor(981.0)
    with torch.no_grad():
        down, mid, up = tunet.brushnet_forward(bn, bcfg, x, t, ehs,
                                               torch.randn((2, 5, 64, 64), generator=g))
        out = tunet.unet2d_forward(unet, ucfg, x, t, ehs, down_block_add_samples=down,
                                   mid_block_add_sample=mid, up_block_add_samples=up)
    assert out.shape == (2, 4, 64, 64)
    assert {c: calls.count(c) for c in set(calls)} == SD15_PER_STEP
    assert set(SD15_PER_STEP) <= set(_kernels.KERNELS)
    assert (calls.count("flash_fwd_d40"), sum("max" in c for c in calls),
            sum("masked" in c for c in calls)) == (5, 10, 18)


# a 768x768 request (96 x 96 latents): (queries, keys, head dim, counter)
SD15_768 = [(9216, 9216, 40, "flash_fwd_d40"), (9216, 77, 40, "flash_small_kv_masked_d40"),
            (2304, 2304, 80, "flash_fwd_d80"), (2304, 77, 80, "flash_small_kv_masked_d80"),
            (576, 576, 160, "flash_small_kv_max_d160"),
            (576, 77, 160, "flash_small_kv_masked_d160"),
            (144, 144, 160, "flash_small_kv_masked_d160"),
            (144, 77, 160, "flash_small_kv_masked_d160"),
            (144, 144, 8, "flash_small_kv_masked_d8")]


@pytest.mark.parametrize("sq,sk,d,counter", SD15_768)
def test_768_shapes_pick_the_forms_the_card_counts(monkeypatch, sq, sk, d, counter):
    """At 768x768, which the app allows, the 2304 tokens at d 80 go to K5
    and the mid block's 144 tokens (padded to 192 on the card) to K4's
    masked form."""
    calls = []
    _spies(monkeypatch, calls)
    q, k = torch.zeros((1, sq, 1, d)), torch.zeros((1, sk, 1, d))
    with torch.no_grad():
        tfa.flash_attention(q, k, k)
    assert calls == [counter]


class _CudaStub:
    """Stands for a bf16 CUDA tensor of head-major q/k/v: what the wrappers
    read before they refuse a form."""
    is_cuda = True
    dtype = torch.bfloat16

    def __init__(self, d):
        self.shape = (2, 128, d)


@pytest.mark.parametrize("d", DIMS)
def test_a_gradient_at_sd15_dims_raises_queue_2b(d):
    """bf16 K6a-c at these head dims are not ported (ROADMAP.md Queue 2 B):
    with a gradient the forward and both backward wrappers raise before
    reaching a kernel, naming that item; without one the form is taken."""
    qh = _CudaStub(d)
    for call in (lambda: tfa.flash_fwd(qh, qh, qh, sk_actual=77, with_lse=True),
                 lambda: tfa.flash_bwd_dq(qh, qh, qh, qh, None, None, sk_actual=77,
                                          dq_factor=1.0),
                 lambda: tfa.flash_bwd_dkv(qh, qh, qh, qh, None, None, sq=128, sk_actual=77)):
        with pytest.raises(ValueError, match=r"with a gradient \(K6a-c\) at head dim "
                                             rf"{d} .*Queue 2 B"):
            call()
    tfa._refuse_unported(qh, grad=False)
    with pytest.raises(ValueError, match="bf16 attention at head dim 48 .*Queue 2 B"):
        tfa._refuse_unported(_CudaStub(48), grad=False)


def test_counters_of_the_sd15_forms():
    """K4's forms and K5 at d 8, 40, 80 and 160 count apart from d 64 and 128
    (whose counters SDXL's and the Wan DiTs' exact counts read)."""
    assert [tfa._dim_counter("flash_fwd", d) for d in (8, 40, 64, 80, 128, 160)] == [
        "flash_fwd_d8", "flash_fwd_d40", "flash_fwd_d64", "flash_fwd_d80", "flash_fwd",
        "flash_fwd_d160"]
    assert [tfa._dim_counter("flash_small_kv_masked", d) for d in (8, 64, 128)] == [
        "flash_small_kv_masked_d8", "flash_small_kv_masked", "flash_small_kv_masked"]
    new = {f"{f}_d{d}" for f in ("flash_fwd", "flash_small_kv_max", "flash_small_kv_masked")
           for d in DIMS}
    assert new <= set(_kernels.launches) and len(_kernels.KERNELS) == len(set(_kernels.KERNELS))
