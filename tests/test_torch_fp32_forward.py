"""K5 and K4's max and masked forms in fp32 without a gradient, at head dims
8, 16, 40, 64, 80 and 160: the forms the SDXL and SD1.5 BrushNet pipelines
reach at their default dtype (fp32), which the card runs on the 3xTF32
forward of csrc/flash_attention_fp32.cu.

- The port's plain versions (what a CPU tensor takes) against the JAX
  package's ``_flash_fwd_impl`` on fp32 inputs, its Pallas kernels in
  interpret mode as tests/test_flash_attention.py runs them: K5 with
  ``bq`` / ``bk`` of 128, so that several query and key tiles run at tiny
  sizes, K4's max form (one k tile), its masked form over 77 keys padded to
  128, and both with a ``kv_len`` that cuts non-zero keys.  In fp32 the
  Pallas kernels round nothing (``p.astype(v.dtype)`` is a no-op), so K4
  and K5 compute one function: the tolerance is a relative L2 error of
  1e-6 and 1e-6 absolute, fp32 sums taken in another order.
- A numpy emulation of the card's steps at each instance's width and key
  tile (32 columns for d 8 and 16, 64 for 40 and 64, 96 for 80, 160 for
  160; 64-key tiles, 32 at 96 and 160 columns; columns past d zero) within
  the card's bound of the plain version: a relative L2 error of 1e-5.
- The forward's pre-pass's plain version and its layout at each head dim.
- The dispatch on the card: each path shape of a 1024x1024 SDXL and a
  512x512 / 768x768 SD1.5 request reaches K4 or K5 in fp32 under the
  counter ``{form}_f32_d{d}``, on a CUDA stand-in with the kernel replaced
  by a spy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fairygen_tpu.ops import flash_attention as jfa
from fairygen_tpu_torch.ops import _kernels
from fairygen_tpu_torch.ops import flash_attention as tfa

from test_torch_fp32_tc import _tc

DIMS = (8, 16, 40, 64, 80, 160)
LOG2E = 1.4426950408889634
# form: (sq, sk, kv_len, bq, bk) of the JAX call
FORMS = {"K5 kv_len": (160, 300, 250, 128, 128),
         "K4 max": (160, 256, None, None, None), "K4 masked": (100, 77, None, None, None),
         "K4 kv_len": (96, 256, 200, None, None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests, restored after (tiny
    shapes; under the suite's six workers torch's thread pools contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("form", list(FORMS))
def test_fp32_plain_forms_match_pallas(form, d):
    sq, sk, kv_len, bq, bk = FORMS[form]
    rng = np.random.default_rng(d * 1000 + sk)
    q, k, v = (rng.standard_normal((1, s, 2, d)).astype(np.float32) for s in (sq, sk, sk))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             kv_len=kv_len, bq=bq, bk=bk))
    with torch.no_grad():
        out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=kv_len)
    assert out.dtype == torch.float32 and out.shape == (1, sq, 2, d)
    assert _rel_l2(out.numpy(), ref) < 1e-6
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


# the card's instances: head dim -> (columns, keys a tile)
INSTANCES = {8: (32, 64), 16: (32, 64), 40: (64, 64), 64: (64, 64), 80: (96, 32),
             160: (160, 32)}


def _emulated(q, k, v, sk_actual, cols, kt):
    """The card's fp32 forward: q, k, v zero-padded to ``cols`` columns; per
    ``kt``-key tile S in 3xTF32, key columns >= sk_actual at -inf, the
    running max and sum in fp32, P = exp2(S - m), O = alpha O + P V with
    each tile's P V a fresh 3xTF32 product; o = O / l, its d columns."""
    d = q.shape[-1]
    pad = [(0, 0), (0, 0), (0, cols - d)]
    q, k, v = (np.pad(x, pad) for x in (q, k, v))
    o = np.empty(q.shape, np.float32)
    for h in range(q.shape[0]):
        m = np.full(q.shape[1], -np.inf, np.float32)
        l = np.zeros(q.shape[1], np.float32)
        acc = np.zeros(q.shape[1:], np.float32)
        for j0 in range(0, sk_actual, kt):
            s = _tc(q[h], k[h, j0:j0 + kt].T)
            s[:, sk_actual - j0:] = -np.inf
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(1, dtype=np.float32)
            acc = acc * alpha[:, None] + _tc(p, v[h, j0:j0 + kt])
            m = m_new
        o[h] = acc / l[:, None]
    assert not o[..., d:].any()
    return o[..., :d]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("sq,sk_pad,sk_actual", [(128, 256, 256), (64, 192, 150),
                                                 (128, 128, 77)])
def test_3xtf32_forward_meets_the_fp32_bound_at_each_width(d, sq, sk_pad, sk_actual):
    rng = np.random.default_rng(d + sk_actual)
    q = (rng.standard_normal((2, sq, d)) * d ** -0.5 * LOG2E).astype(np.float32)
    k, v = (rng.standard_normal((2, sk_pad, d)).astype(np.float32) for _ in range(2))
    k[:, sk_actual:], v[:, sk_actual:] = 7.0, -3.0  # masked keys hold values
    ref = tfa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), sk_actual=sk_actual,
                              with_lse=False)
    assert _rel_l2(_emulated(q, k, v, sk_actual, *INSTANCES[d]), ref.numpy()) < 1e-5


@pytest.mark.parametrize("d", DIMS)
def test_fwd_prep_layout_at_each_head_dim(d):
    """The workspace at the true width: K's TF32 hi and lo (BN, Sk_pad, d),
    then V^T's (BN, d, Sk_pad) with each 8 keys as 0, 2, 4, 6, 1, 3, 5, 7."""
    g = torch.Generator().manual_seed(d)
    kh, vh = torch.randn((3, 128, d), generator=g), torch.randn((3, 128, d), generator=g)
    ws = tfa.fwd_prep_f32_plain(kh, vh)
    n = kh.numel()
    assert ws.shape == (4 * n,)
    k_hi, k_lo, vt_hi, vt_lo = (ws[i * n:(i + 1) * n] for i in range(4))
    assert torch.equal(k_hi.view_as(kh), tfa.tf32_round_plain(kh))
    assert torch.equal(k_lo.view_as(kh), tfa.tf32_round_plain(kh - k_hi.view_as(kh)))
    vt = vt_hi.view(3, d, 128)
    for key, pos in ((0, 0), (2, 1), (6, 3), (1, 4), (7, 7), (9, 12), (127, 127)):
        assert torch.equal(vt[:, :, pos], tfa.tf32_round_plain(vh[:, key]))
    lo = vt_lo.view(3, d, 128)
    assert torch.equal(lo[:, :, 4], tfa.tf32_round_plain(vh[:, 1] - vt[:, :, 4]))


class _CudaStub:
    """Stands for a contiguous fp32 CUDA tensor of head-major q/k/v: what
    the wrappers read before they reach a kernel."""
    is_cuda = True

    def __init__(self, bn, s, d, dtype=torch.float32):
        self.shape, self.dtype = (bn, s, d), dtype


def _spy_kernel(monkeypatch, calls):
    monkeypatch.setattr(tfa, "_check_heads_major", lambda *a, **kw: None)

    def fwd(qh, kh, vh, sk_actual, counter, with_lse):
        calls.append(counter)
        return (qh, None) if with_lse else qh

    monkeypatch.setattr(tfa, "_fwd_f32", fwd)


# the counters of one BrushNet + UNet step at CFG batch 2 in fp32
SDXL_F32_PER_STEP = {"flash_fwd_f32_d64": 10, "flash_small_kv_max_f32_d64": 61,
                     "flash_small_kv_masked_f32_d64": 70}
SD15_F32_PER_STEP = {"flash_fwd_f32_d40": 5, "flash_small_kv_max_f32_d80": 5,
                     "flash_small_kv_max_f32_d160": 5, "flash_small_kv_masked_f32_d40": 5,
                     "flash_small_kv_masked_f32_d80": 5, "flash_small_kv_masked_f32_d160": 7,
                     "flash_small_kv_masked_f32_d8": 1}


@pytest.mark.parametrize("form,bn,sq_pad,sk_pad,sk_actual,d,counter", [
    ("K5", 20, 4096, 4096, 4096, 64, "flash_fwd_f32_d64"),
    ("K4", 40, 1024, 1024, 1024, 64, "flash_small_kv_max_f32_d64"),
    ("K4", 20, 4096, 128, 77, 64, "flash_small_kv_masked_f32_d64"),
    ("K5", 16, 4096, 4096, 4096, 40, "flash_fwd_f32_d40"),
    ("K5", 16, 9216, 9216, 9216, 40, "flash_fwd_f32_d40"),
    ("K5", 16, 2304, 2304, 2304, 80, "flash_fwd_f32_d80"),
    ("K4", 16, 1024, 1024, 1024, 80, "flash_small_kv_max_f32_d80"),
    ("K4", 16, 576, 576, 576, 160, "flash_small_kv_max_f32_d160"),
    ("K4", 16, 64, 128, 64, 160, "flash_small_kv_masked_f32_d160"),
    ("K4", 320, 64, 128, 64, 8, "flash_small_kv_masked_f32_d8"),
    ("K4", 4, 64, 128, 64, 16, "flash_small_kv_masked_f32_d16"),
    ("K5", 4, 1024, 1152, 1100, 16, "flash_fwd_f32_d16"),
])
def test_fp32_wrappers_count_each_form_and_dim(monkeypatch, form, bn, sq_pad, sk_pad, sk_actual,
                                               d, counter):
    """On the card an fp32 call without a gradient is taken (no Queue 2
    refusal) and counted under its form and head dim."""
    calls = []
    _spy_kernel(monkeypatch, calls)
    qh, kh = _CudaStub(bn, sq_pad, d), _CudaStub(bn, sk_pad, d)
    if form == "K5":
        tfa.flash_fwd(qh, kh, kh, sk_actual=sk_actual, with_lse=False)
    else:
        tfa.flash_small_kv_max(qh, kh, kh, sk_actual=sk_actual)
    assert calls == [counter] and counter in _kernels.KERNELS


def test_fp32_counters_are_new_kernels():
    """18 counters of their own, apart from the bf16 forms' and K6a's."""
    new = {tfa._f32_counter(f, d) for f in ("flash_fwd", "flash_small_kv_max",
                                            "flash_small_kv_masked") for d in DIMS}
    assert len(new) == 18 and new <= set(_kernels.launches)
    assert set(SDXL_F32_PER_STEP) | set(SD15_F32_PER_STEP) <= new
    assert len(_kernels.KERNELS) == len(set(_kernels.KERNELS))


@pytest.mark.parametrize("d,grad,bounded", [(128, False, False), (128, True, False),
                                            (40, True, False), (64, False, True)])
def test_fp32_forms_left_in_queue_2_raise(monkeypatch, d, grad, bounded):
    """fp32 at head dim 128 without a gradient, with a gradient at a head dim
    other than 64, and the bounded K3 / K4 in fp32 still raise on the card
    (ROADMAP.md Queue 2 A), before any kernel."""
    calls = []
    _spy_kernel(monkeypatch, calls)
    qh = _CudaStub(2, 128, d)
    with pytest.raises(ValueError, match="Queue 2 A"):
        if bounded:
            tfa.flash_attention_heads_major(qh, qh, qh, b=1, n=2, sq=128, sk_actual=128,
                                            bq=128, bk=128)
        else:
            tfa.flash_fwd(qh, qh, qh, sk_actual=100, with_lse=grad)
    assert calls == []


@pytest.mark.parametrize("sq,sk,d,counter", [
    (4096, 4096, 64, "flash_fwd_f32_d64"), (1024, 1024, 64, "flash_small_kv_max_f32_d64"),
    (4096, 77, 64, "flash_small_kv_masked_f32_d64"), (4096, 4096, 40, "flash_fwd_f32_d40"),
    (1024, 1024, 80, "flash_small_kv_max_f32_d80"), (256, 256, 160, "flash_small_kv_max_f32_d160"),
    (256, 77, 160, "flash_small_kv_masked_f32_d160"), (64, 64, 160, "flash_small_kv_masked_f32_d160"),
    (64, 64, 8, "flash_small_kv_masked_f32_d8"), (2304, 2304, 80, "flash_fwd_f32_d80"),
    (144, 144, 8, "flash_small_kv_masked_f32_d8"), (64, 64, 16, "flash_small_kv_masked_f32_d16")])
def test_the_generic_entry_picks_the_fp32_forms(monkeypatch, sq, sk, d, counter):
    """The generic entry on fp32 (B, S, N, d) inputs: the request shapes go
    to K5 or K4's max or masked form as in bf16 (keys padded to a multiple of
    64 on the card: 144 -> 192, the masked form), each counted in fp32."""
    calls = []

    def spy(kernel):
        def fn(qh, kh, vh, *, sk_actual, **kw):
            assert qh.dtype == torch.float32
            if kernel == "flash_fwd":
                calls.append(tfa._f32_counter("flash_fwd", qh.shape[-1]))
            else:
                card_pad = tfa._pad_len(sk_actual, tfa._tiles(qh.shape[1], sk_actual)[1], True)
                form = "flash_small_kv_masked" if sk_actual < card_pad else "flash_small_kv_max"
                calls.append(tfa._f32_counter(form, qh.shape[-1]))
            return torch.zeros_like(qh)
        return fn

    monkeypatch.setattr(tfa, "flash_small_kv_max", spy("K4"))
    monkeypatch.setattr(tfa, "flash_fwd", spy("flash_fwd"))
    q, k = torch.zeros((1, sq, 1, d)), torch.zeros((1, sk, 1, d))
    with torch.no_grad():
        tfa.flash_attention(q, k, k)
    assert calls == [counter]
