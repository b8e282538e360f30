"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version on the card, a tiny pipeline that must
launch the four serving kernels, the flash-attention gradient against
autograd of the plain attention, a tiny LoRA train step and a tiny
direct-distill step (gradients through a 2-step rollout) that must launch
K6a-c, a tiny remat="offload" step whose gradients must equal remat=True's
bit for bit, a tiny FLUX.1 pipeline that must launch K1, K7, K8 and K3/K4, or
K10 with EliGen regions, and a tiny Z-Image pipeline that must launch K9,
K7 and K4, K4's max and masked forms and K5 at head dim 64 (and their
refusals), and a tiny SDXL + BrushNet + DoRA pipeline that must launch
them.  K10 and K5 at head dim 64 are also held at ragged tile edges
(sq = 129 with an odd Sk = 4097; sq = 300 with sk_actual = 4000 over
non-zero keys) and K10 where a q tile's first key tiles are fully
masked; K4's max and masked forms also at a half q tile, at 192 keys (a
key box past Sk_pad), at 80 and 64 keys (the 80-column form at head dim
64) and at a kv_len of 1000 of 1024, within a relative
L2 error of 2^-10, over 40 heads of one key tile (several items a CTA),
and two of their runs must give the same bits; K5 at head dim 128 and
K6a with a kv_len inside the last 128-key tile (1030 of 1100), K6a's lse
fed to K6b and K6c, and one launch each; the streamed VAE38 decode
against the full-sequence one, a four-tile decode against the CPU, and a
hot LoRA through K1-K4 (the tiny pipelines also launch K11 in the VAE);
K6b and K6c likewise (sq = 129 / Sk = 4097, sq = 300 with sk_actual =
4000, one partial key tile at sk = 77), and two of their runs must give
the same bits.  They skip here when no card is present; on a
card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: bf16 outputs, 1 bf16 ulp (<= 2^-7 relative) for K1/K2 and the
same plus 1e-3 absolute for the attention kernels (p is rounded to bf16
before the p·v product on both sides; sums run in other orders).  K7/K8
compute the per-head statistic in another order than the plain version,
so a bf16 rounding of a normed value may flip, and the rotation moves both
outputs of its pair by about one ulp of the pair's magnitude: 2 bf16 ulps
of max(|y_2i|, |y_2i+1|), the bound of the CPU tests.  K10 rounds p against the running
max of its key tile, as K5 does: 2^-7 relative + 2^-8 absolute.  K6b/K6c
round P and dS to bf16 before their products on both sides, but at values
that differ in the last fp32 bits (sums in another order), so a term may
move by one bf16 ulp: their gradients are held to 2^-7 relative plus 1e-2
of the largest |gradient|.  K9 and K11 sum the squares of a row in another
order than PyTorch's reduction, and the rest of their arithmetic is the
plain version's, rounding for rounding; each output is monotone in the
row's fp32 statistic, so it must lie between the plain formula evaluated
with that statistic moved down and up by 2^-14 (relative), far more than a
different summation order moves it and far less than one bf16 ulp.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _close_rotated(out, ref, normed):
    """|out - ref| <= 2 bf16 ulps (2 x 2^-7) of the rotated pair's magnitude
    max(|y_2i|, |y_2i+1|) of the normed values (see the module note)."""
    n = normed.float()
    pair = torch.maximum(n[..., 0::2].abs(), n[..., 1::2].abs()).repeat_interleave(2, -1)
    assert bool(((out.float() - ref.float()).abs() <= 2 * 2 ** -7 * pair).all())


def _randn(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("s,seg", [(1, 0), (300, 77), (1950, 390)])
def test_k1_matches_plain(card, s, seg):
    from fairygen_tpu_torch.ops.fused_norms import layer_norm_modulate, layer_norm_modulate_plain

    x = _randn(card, 2, s, 3072)
    sh, sc = _randn(card, 2, 2, 3072, scale=0.1), _randn(card, 2, 2, 3072, scale=0.1)
    torch.testing.assert_close(layer_norm_modulate(x, sh, sc, seg).float(),
                               layer_norm_modulate_plain(x, sh, sc, seg).float(),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("s", [60, 1100])
@pytest.mark.parametrize("rope", [True, False])
def test_k2_matches_plain_exactly(card, s, rope):
    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.rope import build_freqs_grid, precompute_freqs_3d

    n, grid = 4, {60: (3, 4, 5), 1100: (11, 10, 10)}[s]
    x, gamma = _randn(card, 1, s, n * 128), _randn(card, n * 128)
    ff = fq.build_freqs_full(build_freqs_grid(precompute_freqs_3d(128), *grid, device="cuda"))
    rs = fq._rowscale(x, 1e-6)
    s_pad = fq._pad_for_flash(s)[0]
    out = fq.rms_rope_heads_major(x, gamma, rs, ff, n, s_pad, rope=rope)
    ref = fq.rms_rope_heads_major_plain(x, gamma, rs, ff, n, s_pad, rope=rope)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _normed(card, *shape, scale=1.0):
    x = torch.randn(shape, generator=card, device="cuda")
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale).to(torch.bfloat16)


def _k3_k4_heads_major(card, b, n, sq, sk):
    """K2-normed q/k padded as the DiT call sites pad them, through the
    bounded entry; returns (out, plain)."""
    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (flash_attention_heads_major,
                                                         flash_attention_heads_major_plain)

    xq, xk = _randn(card, b, sq, n * 128), _randn(card, b, sk, n * 128)
    gq = _randn(card, n * 128, scale=128 ** -0.5 * 1.4427)
    gk = _randn(card, n * 128)
    v = _randn(card, b, sk, n, 128)
    q_pad, bq, bk = fq._pad_for_flash(sq)
    qh = fq.rms_rope_heads_major(xq, gq, fq._rowscale(xq, 1e-6), None, n, q_pad, rope=False)
    if sq == sk:
        k_pad = q_pad
    else:
        k_pad = bk = max(128, -(-sk // 128) * 128)
    kh = fq.rms_rope_heads_major(xk, gk, fq._rowscale(xk, 1e-6), None, n, k_pad, rope=False)
    out = flash_attention_heads_major(qh, kh, v, b=b, n=n, sq=sq, sk_actual=sk, bq=bq, bk=bk)
    return out, flash_attention_heads_major_plain(qh, kh, v, b=b, n=n, sq=sq, sk_actual=sk)


def _k3_k4_generic(card, b, n, sq, sk):
    """``flash_attention(..., bounded_logits=True)``: the card pads q and k
    to 64 rows, so a 128-row tile of the kernel reaches past them; the same
    call on the CPU takes the plain version."""
    from fairygen_tpu_torch.ops.flash_attention import flash_attention

    q = _normed(card, b, sq, n, 128, scale=128 ** -0.5 * 1.4426950408889634)
    k, v = _normed(card, b, sk, n, 128), _randn(card, b, sk, n, 128)
    out = flash_attention(q, k, v, prescaled=True, bounded_logits=True)
    return out, flash_attention(q.cpu(), k.cpu(), v.cpu(), prescaled=True,
                                bounded_logits=True)


def _k3_k4_joint(card, b, n, s_i, s_t, monkeypatch):
    """FLUX.1's joint layout through ``fused_qk_attention_joint``: the image
    rows pad to 3072, so a zero gap of 972 keys (more than one key tile)
    sits inside [0, Lv); the bounded call it makes is held against the plain
    version on the same inputs."""
    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (flash_attention_heads_major,
                                                         flash_attention_heads_major_plain)

    pairs = []

    def spy(qh, kh, v, **kw):
        out = flash_attention_heads_major(qh, kh, v, **kw)
        kw.pop("bq"), kw.pop("bk")
        pairs.append((out, flash_attention_heads_major_plain(qh, kh, v, **kw)))
        return out

    monkeypatch.setattr(fq, "flash_attention_heads_major", spy)

    def tables(s):
        ang = torch.rand((s, 64), generator=card, device="cuda") * 6.283
        return torch.cos(ang), torch.sin(ang)

    d = n * 128
    fq.fused_qk_attention_joint(
        _randn(card, b, s_t, d), _randn(card, b, s_t, d), _randn(card, b, s_t, n, 128),
        _randn(card, b, s_i, d), _randn(card, b, s_i, d), _randn(card, b, s_i, n, 128),
        _randn(card, 128, scale=0.13), _randn(card, 128), _randn(card, 128, scale=0.13),
        _randn(card, 128), *tables(s_t), *tables(s_i), n, 1e-6)
    assert len(pairs) == 1
    return pairs[0]


@pytest.mark.parametrize("case", [
    pytest.param(("heads_major", 1, 3, 300, 300), id="300-300"),
    pytest.param(("heads_major", 1, 3, 1100, 1100), id="1100-1100"),
    pytest.param(("heads_major", 1, 3, 300, 77), id="300-77"),
    pytest.param(("heads_major", 1, 3, 1950, 512), id="1950-512"),
    pytest.param(("heads_major", 2, 3, 1500, 1500), id="b2-lv1500-of-2048"),
    pytest.param(("generic", 1, 2, 300, 300), id="generic-64-row-remainder-k4"),
    pytest.param(("generic", 2, 2, 300, 1100), id="generic-64-row-remainder-k3"),
    pytest.param(("heads_major", 1, 30, 320, 320), id="z-image-caption-320"),
    pytest.param(("joint", 1, 2, 2100, 512), id="flux-joint-gap-972"),
])
def test_k3_k4_match_plain(card, case, monkeypatch):
    """K3/K4 against the plain version: four DiT shapes at B = 1, two
    batches whose Lv stops short of the padded keys, q and key lengths
    padded to 64 rows (a 128-row tile of the kernel reaches past them), the
    Z-Image caption refiner's 320 tokens in one 1024-key tile, and the
    FLUX.1 joint layout with a zero gap longer than one key tile."""
    kind, b, n, sq, sk = case
    if kind == "heads_major":
        out, ref = _k3_k4_heads_major(card, b, n, sq, sk)
    elif kind == "generic":
        out, ref = _k3_k4_generic(card, b, n, sq, sk)
    else:
        out, ref = _k3_k4_joint(card, b, n, sq, sk, monkeypatch)
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(), rtol=2 ** -7, atol=1e-3)


def test_tiny_pipeline_launches_every_kernel(card):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=32, freq_dim=32,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    pipe = WanVideoPipeline(convert.init_dit_params(cfg), cfg,
                            convert.init_vae_params(WanVAEConfig.tiny()), WanVAEConfig.tiny())
    ctx = _randn(card, 1, 20, 32)
    _kernels.reset_launches()
    video = pipe(context=ctx, negative_context=torch.zeros_like(ctx),
                 input_image=torch.randint(0, 256, (512, 512, 3), dtype=torch.uint8).numpy(),
                 height=512, width=512, num_frames=17, num_inference_steps=2,
                 output_type="floatpoint")
    assert torch.isfinite(video).all() and video.shape == (1, 3, 17, 512, 512)
    sweeps, layers = 4, 2
    # the tiny VAE38's norm + SiLU: 13 in the first-frame encode, 21 in the decode
    assert _kernels.launches == {"ln_modulate": 3 * layers * sweeps,
                                 "rms_rope_heads_major": 3 * layers * sweeps,
                                 "flash_bounded": layers * sweeps,
                                 "flash_small_kv": layers * sweeps,
                                 "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0, "rms_rope_per_head": 0,
                                 "rms_rope_joint": 0, "flash_bias": 0, "rms_modulate": 0,
                                 "vae_rms_silu": 13 + 21, "flash_small_kv_max": 0,
                                 "flash_small_kv_masked": 0, "flash_fwd_d64": 0}


def _close_grad(out, ref):
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -7,
                               atol=1e-2 * ref.abs().max().item())


def _k6_inputs(g, sq, sk, n):
    """Seeded head-major q (prescaled), k, v and dO of n heads, zero-padded
    as the gradient path pads them."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    q = _randn(g, 1, sq, n, 128, scale=128 ** -0.5 * 1.4427)
    k, v, do = _randn(g, 1, sk, n, 128), _randn(g, 1, sk, n, 128), _randn(g, 1, sq, n, 128)
    bq, bk = fa._tiles(sq, sk)
    qh = fa._heads_major(q, fa._pad_len(sq, bq, True))
    kh, vh = (fa._heads_major(t, fa._pad_len(sk, bk, True)) for t in (k, v))
    doh = fa._heads_major(do, qh.shape[1])
    return qh, kh, vh, doh


@pytest.mark.parametrize("sq,sk,kv_len", [(300, 300, None), (1100, 1100, None),
                                          (300, 77, None), (1950, 512, None),
                                          (700, 700, 650), (1100, 1100, 1030)])
def test_k5_k6_match_plain(card, sq, sk, kv_len):
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh, doh = _k6_inputs(card, sq, sk, 3)
    ska = sk if kv_len is None else kv_len
    o, lse = fa.flash_fwd(qh, kh, vh, sk_actual=ska)
    o_ref, lse_ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
    # p is rounded to bf16 against the running max of its key tile, not
    # the row's final max: a term moves by up to 2^-9 of p·|v|, so the
    # output by up to 2^-9 of mean |v| (~1.6e-3 for unit-normal v)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2 ** -7, atol=2 ** -8)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False), o,
                               rtol=0, atol=0)
    delta = (doh.float() * o_ref.float()).sum(-1)
    dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska, dq_factor=0.5)
    _close_grad(dq, fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse_ref, delta, sk_actual=ska,
                                          dq_factor=0.5))
    dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse_ref, delta, sq=sq, sk_actual=ska)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse_ref, delta, sq=sq,
                                            sk_actual=ska)
    _close_grad(dk, dk_ref)
    _close_grad(dv, dv_ref)
    assert torch.all(dk[:, ska:] == 0) and torch.all(dv[:, ska:] == 0)


@pytest.mark.parametrize("sq,sk,kv_len", [(300, 300, None), (1100, 1100, 1030)])
def test_k6a_lse_feeds_k6b_k6c(card, sq, sk, kv_len):
    """The gradient path as it runs: K6a's own o and lse fed to K6b and K6c
    give dq, dk and dv within _close_grad of the same kernels fed the plain
    version's o and lse (K6a's lse is within 1e-5 / 1e-4 of it)."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh, doh = _k6_inputs(card, sq, sk, 2)
    ska = sk if kv_len is None else kv_len
    grads = []
    for o, lse in (fa.flash_fwd(qh, kh, vh, sk_actual=ska),
                   fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)):
        delta = (doh.float() * o.float()).sum(-1)
        grads.append((fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, sk_actual=ska,
                                      dq_factor=0.5),)
                     + fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=ska))
    for got, ref in zip(*grads):
        _close_grad(got, ref)


def test_k5_k6a_at_head_dim_128_launch_one_kernel(card):
    """One flash_fwd call at head dim 128 launches K5 once and nothing else;
    with the lse, K6a once and nothing else."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh, _ = _k6_inputs(card, 300, 300, 2)
    for with_lse, want in ((False, {"flash_fwd": 1}), (True, {"flash_fwd_lse": 1})):
        _kernels.reset_launches()
        fa.flash_fwd(qh, kh, vh, sk_actual=300, with_lse=with_lse)
        assert {k: v for k, v in _kernels.launches.items() if v} == want


@pytest.mark.parametrize("sq,sk,kv_len", [(129, 4097, None), (300, 4097, 4000), (1950, 77, None)])
def test_k6b_k6c_ragged_edges_match_plain(card, sq, sk, kv_len):
    """K6b and K6c at the edges of their tiles.  sq = 129 pads to Sq_pad =
    192, so K6b's second 128-row item reaches past Sq_pad and K6c's last
    64-query tile holds one real query; Sk = 4097 (Sk_pad 5120) leaves one
    real key in the last 128-key tile.  sq = 300 with kv_len 4000 of 4097
    keys: the keys past sk_actual hold non-zero values and must be masked,
    not counted as zero rows, and K6c's key items at or past 4096 store
    zeros.  sq = 1950, sk = 77: one partial key tile.  One launch on each
    counter; tolerances as in test_k5_k6_match_plain."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh, doh = _k6_inputs(card, sq, sk, 2)
    ska = sk if kv_len is None else kv_len
    o_ref, lse = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska)
    delta = (doh.float() * o_ref.float()).sum(-1)
    _kernels.reset_launches()
    dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, sk_actual=ska, dq_factor=0.5)
    dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=ska)
    assert {k: v for k, v in _kernels.launches.items() if v} == {"flash_bwd_dq": 1,
                                                                  "flash_bwd_dkv": 1}
    _close_grad(dq, fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta, sk_actual=ska,
                                          dq_factor=0.5))
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse, delta, sq=sq, sk_actual=ska)
    _close_grad(dk, dk_ref)
    _close_grad(dv, dv_ref)
    assert torch.all(dk[:, ska:] == 0) and torch.all(dv[:, ska:] == 0)


def test_k6b_k6c_are_deterministic(card):
    """No atomics: each output element is written by one CTA, so two calls
    at 2 heads x 1100 (kv_len 1050 over non-zero keys) give dq, dk and dv
    bit for bit equal, and the dk and dv rows >= sk_actual are exactly 0."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh, doh = _k6_inputs(card, 1100, 1100, 2)
    o_ref, lse = fa.flash_fwd_plain(qh, kh, vh, sk_actual=1050)
    delta = (doh.float() * o_ref.float()).sum(-1)
    _kernels.reset_launches()
    runs = [(fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, sk_actual=1050, dq_factor=0.5),)
            + fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, sq=1100, sk_actual=1050)
            for _ in range(2)]
    assert {k: v for k, v in _kernels.launches.items() if v} == {"flash_bwd_dq": 2,
                                                                  "flash_bwd_dkv": 2}
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    dk, dv = runs[0][1:]
    assert torch.all(dk[:, 1050:] == 0) and torch.all(dv[:, 1050:] == 0)


@pytest.mark.parametrize("prescaled,kv_len", [(True, None), (False, None), (True, 450)])
def test_flash_attention_gradient_matches_autograd_of_plain(card, prescaled, kv_len):
    """bf16 kernels against fp32 autograd of the plain attention on the same
    bf16 values: relative L2 error of each gradient below 1e-2 (bf16
    roundings of P, dS and the outputs)."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops.attention import xla_attention
    from fairygen_tpu_torch.ops.flash_attention import flash_attention

    sc = 128 ** -0.5 * 1.4427 if prescaled else 1.0
    q = _randn(card, 1, 500, 2, 128, scale=sc).requires_grad_(True)
    k = _randn(card, 1, 500, 2, 128).requires_grad_(True)
    v = _randn(card, 1, 500, 2, 128).requires_grad_(True)
    w = _randn(card, 1, 500, 2, 128).float()
    _kernels.reset_launches()
    out = flash_attention(q, k, v, prescaled=prescaled, kv_len=kv_len)
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert [_kernels.launches[x] for x in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")] \
        == [1, 1, 1]
    ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = xla_attention(*ref_in, prescaled=prescaled, kv_len=kv_len)
    ref_grads = torch.autograd.grad((ref * w).sum(), ref_in)
    for name, a, b in zip("qkv", grads, ref_grads):
        rel = ((a.float() - b).norm() / b.norm()).item()
        assert rel < 1e-2, (name, rel)


def test_tiny_lora_train_step_launches_k6_and_moves_only_adapters(card):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.adapters import add_lora_to_wan_dit, lora_trainable_filter
    from fairygen_tpu_torch.models.adapters import leaves_with_path
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.train_step import make_wan_sft_train_step

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=32, freq_dim=32,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    params = add_lora_to_wan_dit(convert.init_dit_params(cfg), card, rank=8)
    before = {p: t.clone() for p, t in leaves_with_path(params) if isinstance(t, torch.Tensor)}
    init, step = make_wan_sft_train_step(cfg, make_optimizer("adamw", 1e-3, 0.01), remat=True,
                                         trainable_filter=lora_trainable_filter(("A", "B")),
                                         lora_b_dropout=("B", 0.8))
    state = init(params)
    batch = {"latents": _randn(card, 1, 4, 5, 16, 16), "context": _randn(card, 1, 20, 32)}
    _kernels.reset_launches()
    state, loss = step(state, batch, card)
    assert torch.isfinite(loss)
    layers = cfg.num_layers
    assert {k: _kernels.launches[k] for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv",
                                              "flash_fwd")} == {"flash_fwd_lse": 2 * layers,
                                                                "flash_bwd_dq": 2 * layers,
                                                                "flash_bwd_dkv": 2 * layers,
                                                                "flash_fwd": 0}
    for path, t in leaves_with_path(state.params):
        if not isinstance(t, torch.Tensor):
            continue
        if "lora" in path and path[-1] == "B":
            assert not torch.equal(t, before[path]), path
        elif "lora" not in path:
            assert torch.equal(t, before[path]), path


def _tiny_lora_dit(card):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.adapters import add_lora_to_wan_dit
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=32, freq_dim=32,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    params = add_lora_to_wan_dit(convert.init_dit_params(cfg), card, rank=8)
    for blk in params["blocks"]:  # non-zero B, so that A gets a gradient too
        for layer in (blk["self_attn"]["q"], blk["ffn"]["fc1"]):
            layer["lora"]["B"].normal_(generator=card).mul_(0.02)
    batch = {"latents": _randn(card, 1, 4, 5, 16, 16), "context": _randn(card, 1, 20, 32)}
    return cfg, params, batch


def test_tiny_direct_distill_step_launches_k6(card):
    """One direct-distill step: a 2-step student rollout with gradients
    through both sweeps, so K6a, K6b and K6c run 2 x 2 x layers times."""
    from fairygen_tpu_torch.models.adapters import leaves_with_path, lora_trainable_filter
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.train_step import make_wan_distill_train_step

    cfg, params, batch = _tiny_lora_dit(card)
    before = {p: t.clone() for p, t in leaves_with_path(params) if isinstance(t, torch.Tensor)}
    init, step = make_wan_distill_train_step(cfg, make_optimizer("adamw", 1e-3, 0.01),
                                             num_inference_steps=2,
                                             trainable_filter=lora_trainable_filter(("A", "B")))
    state = init(params)
    _kernels.reset_launches()
    state, loss = step(state, batch, card)
    assert torch.isfinite(loss)
    n = 2 * 2 * cfg.num_layers
    assert {k: _kernels.launches[k] for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv",
                                              "flash_fwd")} == {"flash_fwd_lse": n,
                                                                "flash_bwd_dq": n,
                                                                "flash_bwd_dkv": n,
                                                                "flash_fwd": 0}
    for path, t in leaves_with_path(state.params):
        if isinstance(t, torch.Tensor) and "lora" not in path:
            assert torch.equal(t, before[path]), path
    assert any(not torch.equal(t, before[p]) for p, t in leaves_with_path(state.params)
               if "lora" in p and p[-1] == "A")


def test_tiny_offload_step_gives_the_remat_gradients(card):
    """remat="offload" parks each block's carry in pinned host memory on a
    side stream and brings it back for the recompute: the loss and every
    LoRA gradient equal remat=True's bit for bit."""
    from fairygen_tpu_torch.models.adapters import lora_trainable_filter
    from fairygen_tpu_torch.models.wan import dit
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.train_step import make_wan_sft_train_step

    cfg, params, batch = _tiny_lora_dit(card)
    noise = _randn(card, 1, 4, 5, 16, 16)
    parked = []
    original = dit.offload_saved_carry

    class Counting(original):
        def __exit__(self, *exc):
            parked.append(self.parked)
            return super().__exit__(*exc)

    out = []
    try:
        dit.offload_saved_carry = Counting
        for remat in (True, "offload"):
            init, step = make_wan_sft_train_step(cfg, make_optimizer(), remat=remat,
                                                 trainable_filter=lora_trainable_filter())
            out.append(step.loss_and_grads(init(params), batch, index=500, noise=noise))
    finally:
        dit.offload_saved_carry = original
    assert parked == [1] * cfg.num_layers
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


@pytest.mark.parametrize("s", [300, 1100])
def test_k7_matches_plain(card, s):
    from fairygen_tpu_torch.ops import fused_qk as fq

    n = 3
    qkv = _randn(card, 1, s, 3 * n * 128)  # a column slice, as the DiT passes it
    x, gamma = qkv[..., n * 128:2 * n * 128], _randn(card, 128)
    ang = torch.rand((s, 64), generator=card, device="cuda") * 6.28
    ff = fq.build_freqs_full_pairs(torch.cos(ang), torch.sin(ang))
    s_pad = fq._pad_for_flash(s)[0]
    out = fq.rms_rope_heads_major_per_head(x, gamma, ff, n, s_pad, eps=1e-6)
    ref = fq.rms_rope_heads_major_per_head_plain(x, gamma, ff, n, s_pad, eps=1e-6)
    ident = fq.build_freqs_full_pairs(torch.ones_like(ang), torch.zeros_like(ang))
    _close_rotated(out, ref, fq.rms_rope_heads_major_per_head_plain(x, gamma, ident, n, s_pad,
                                                                    eps=1e-6))
    assert torch.all(out[:, s:] == 0)


@pytest.mark.parametrize("s_t,s_i", [(77, 300), (512, 4096)])
def test_k8_matches_plain(card, s_t, s_i):
    from fairygen_tpu_torch.ops import fused_qk as fq

    n = 2
    xi, xt = _randn(card, 1, s_i, n * 128), _randn(card, 1, s_t, n * 128)
    gi, gt = _randn(card, 128), _randn(card, 128)
    i_pad = -(-s_i // 1024) * 1024
    s_pad = i_pad + -(-s_t // 1024) * 1024
    ai = torch.rand((s_i, 64), generator=card, device="cuda") * 6.28
    at = torch.rand((s_t, 64), generator=card, device="cuda") * 6.28
    ff = fq.build_freqs_full_joint(torch.cos(ai), torch.sin(ai), torch.cos(at), torch.sin(at),
                                   i_pad, s_pad)
    out = fq.rms_rope_heads_major_joint(xi, xt, gi, gt, ff, n, i_pad, s_pad, eps=1e-6)
    ref = fq.rms_rope_heads_major_joint_plain(xi, xt, gi, gt, ff, n, i_pad, s_pad, eps=1e-6)
    ident = fq.build_freqs_full_joint(torch.ones_like(ai), torch.zeros_like(ai),
                                      torch.ones_like(at), torch.zeros_like(at), i_pad, s_pad)
    _close_rotated(out, ref, fq.rms_rope_heads_major_joint_plain(xi, xt, gi, gt, ident, n, i_pad,
                                                                 s_pad, eps=1e-6))
    assert torch.all(out[:, s_i:i_pad] == 0) and torch.all(out[:, i_pad + s_t:] == 0)


@pytest.mark.parametrize("b,bias_b,sq,sk", [(1, 1, 300, 300), (2, 1, 200, 333),
                                            (1, 1, 1100, 1100), (2, 2, 700, 650)])
def test_k10_matches_plain(card, b, bias_b, sq, sk):
    from fairygen_tpu_torch.ops import flash_attention as fa

    n = 3
    q = _randn(card, b, sq, n, 128, scale=128 ** -0.5 * 1.4427)
    k, v = _randn(card, b, sk, n, 128), _randn(card, b, sk, n, 128)
    allow = torch.rand((bias_b, sq, sk), generator=card, device="cuda") < 0.6
    allow[:, :, 0] = True
    bias = torch.where(allow, 0.3 * torch.randn((bias_b, sq, sk), generator=card, device="cuda"),
                       torch.tensor(-1e30, device="cuda"))
    qh = fa._heads_major(q, fa._pad_len(sq, 64, False))
    kh, vh = (fa._heads_major(t, fa._pad_len(sk, 64, False)) for t in (k, v))
    out = fa.flash_attention_bias_heads_major(qh, kh, vh, bias, n=n, sq=sq, sk=sk)
    ref = fa.flash_attention_bias_plain(qh, kh, vh, bias, n=n, sq=sq, sk=sk)
    torch.testing.assert_close(out[:, :sq].float(), ref[:, :sq].float(), rtol=2 ** -7,
                               atol=2 ** -8)


def _k10_case(card, b, bias_b, sq, sk, n, bias):
    """K10 through the head-major entry on q/k/v padded to 64 rows, against
    the plain version on the rows < sq; exactly one launch, counted under
    flash_bias.  Tolerance as test_k10_matches_plain's."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    q = _randn(card, b, sq, n, 128, scale=128 ** -0.5 * 1.4427)
    k, v = _randn(card, b, sk, n, 128), _randn(card, b, sk, n, 128)
    qh = fa._heads_major(q, fa._pad_len(sq, 64, False))
    kh, vh = (fa._heads_major(t, fa._pad_len(sk, 64, False)) for t in (k, v))
    _kernels.reset_launches()
    out = fa.flash_attention_bias_heads_major(qh, kh, vh, bias, n=n, sq=sq, sk=sk)
    assert {name: c for name, c in _kernels.launches.items() if c} == {"flash_bias": 1}
    ref = fa.flash_attention_bias_plain(qh, kh, vh, bias, n=n, sq=sq, sk=sk)
    torch.testing.assert_close(out[:, :sq].float(), ref[:, :sq].float(), rtol=2 ** -7,
                               atol=2 ** -8)


def test_k10_ragged_edges_match_plain(card):
    """sq = 129 (a q tile of one real row past the first) and Sk = 4097: odd,
    so no bias row starts 16-byte aligned and the last key tile holds one
    real key."""
    sq, sk = 129, 4097
    allow = torch.rand((1, sq, sk), generator=card, device="cuda") < 0.6
    allow[:, :, 0] = True
    bias = torch.where(allow, 0.3 * torch.randn((1, sq, sk), generator=card, device="cuda"),
                       torch.tensor(-1e30, device="cuda"))
    _k10_case(card, 1, 1, sq, sk, 3, bias)


@pytest.mark.parametrize("s", [640, 600])
def test_k10_fully_masked_first_key_tiles_match_plain(card, s):
    """A batch-2 bias in which, as for EliGen's prompt rows, the q rows
    128..255 of the second batch row see nothing (-1e30) in the first three
    key tiles: their running max starts at -1.44e30 and jumps at the fourth
    tile.  s = 640 takes the aligned form (whole tiles; the bias by TMA),
    600 the ragged one."""
    allow = torch.rand((2, s, s), generator=card, device="cuda") < 0.6
    allow[:, :, 0] = True
    allow[1, 128:256, :384] = False
    allow[1, 128:256, 384] = True
    bias = torch.where(allow, 0.3 * torch.randn((2, s, s), generator=card, device="cuda"),
                       torch.tensor(-1e30, device="cuda"))
    _k10_case(card, 2, 2, s, s, 3, bias)


@pytest.mark.parametrize("eligen", [False, True])
def test_tiny_flux_pipeline_launches_its_kernels(card, eligen):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.flux.dit import FluxDiTConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.flux_image import FluxImagePipeline

    cfg = FluxDiTConfig(dim=256, num_heads=2, context_dim=64, pooled_dim=32,
                        num_double_blocks=2, num_single_blocks=2)
    vae_cfg = AutoencoderKLConfig(latent_channels=16, block_out_channels=(32, 32, 32, 32),
                                  norm_num_groups=8, scaling_factor=0.3611,
                                  shift_factor=0.1159, use_quant_conv=False)
    pipe = FluxImagePipeline(convert.init_flux_dit_params(cfg), cfg,
                             convert.init_autoencoder_kl_params(vae_cfg), vae_cfg)
    kw = {}
    if eligen:
        masks = torch.zeros((1, 2, 1, 32, 32), device="cuda")
        masks[:, 0, :, :16] = 1
        masks[:, 1, :, :, 16:] = 1
        kw = dict(eligen_entity_prompts=_randn(card, 1, 2, 40, 64), eligen_entity_masks=masks)
    _kernels.reset_launches()
    # 32 x 32 latents: 256 image tokens (K1's gate opens on the image
    # stream, the 40 text tokens take the plain expression)
    img = pipe(prompt_emb=_randn(card, 1, 40, 64), pooled_prompt_emb=_randn(card, 1, 32),
               height=256, width=256, num_inference_steps=2, seed=1, **kw)
    assert torch.isfinite(img).all() and img.shape == (1, 3, 256, 256)
    sweeps, dbl, sgl = 2, 2, 2
    got = {k: v for k, v in _kernels.launches.items() if v}
    k1 = (2 * dbl + sgl + 1) * sweeps  # image stream x2 per double block, single, final
    if eligen:
        assert got == {"ln_modulate": k1, "flash_bias": (dbl + sgl) * sweeps}
    else:
        assert got["rms_rope_joint"] == 2 * dbl * sweeps
        assert got["rms_rope_per_head"] == 2 * sgl * sweeps
        assert got["ln_modulate"] == k1
        assert got.get("flash_bounded", 0) + got.get("flash_small_kv", 0) == (dbl + sgl) * sweeps


def _k9_bracket(x, w, sc, eps):
    """The plain K9 formula with its statistic moved by -2^-14 and +2^-14
    (relative): (low, high) elementwise."""
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    outs = []
    for f in (1 - 2 ** -14, 1 + 2 ** -14):
        y = (xf * (r * f)).to(x.dtype) * w.to(x.dtype)
        if sc is not None:
            y = y * sc.reshape(sc.shape[0], 1, -1).to(x.dtype)
        outs.append(y.float())
    return torch.minimum(*outs), torch.maximum(*outs)


def _k11_bracket(x, gamma, silu):
    """The plain K11 formula with the row norm moved by -2^-14 and +2^-14
    (relative): (low, high) elementwise, widened by a few fp32 ulps for
    fp32 SiLU outputs."""
    xf = x.float()
    n = torch.sqrt((xf * xf).sum(-1, keepdim=True))
    outs = []
    for f in (1 - 2 ** -14, 1 + 2 ** -14):
        y = (xf / torch.clamp_min(n * f, 1e-12) * (x.shape[-1] ** 0.5) * gamma.float()).to(x.dtype)
        if silu:
            y = torch.nn.functional.silu(y.float()).to(x.dtype)
        outs.append(y.float())
    lo, hi = torch.minimum(*outs), torch.maximum(*outs)
    if silu and x.dtype == torch.float32:
        # where SiLU's slope vanishes its fp32 rounding is not monotone: 2^-21
        # (a few fp32 ulps) of slack
        lo, hi = lo - 2 ** -21 * lo.abs(), hi + 2 ** -21 * hi.abs()
    return lo, hi


def _inside(t, lo, hi):
    return bool(((lo <= t.float()) & (t.float() <= hi)).all())


@pytest.mark.parametrize("shape,dtype,with_scale", [
    ((1, 4416, 3840), torch.bfloat16, True), ((1, 320, 3840), torch.bfloat16, False),
    ((2, 300, 256), torch.bfloat16, True), ((2, 256, 3840), torch.float32, True),
    ((1, 512, 384), torch.float32, False)])
def test_k9_matches_plain(card, shape, dtype, with_scale):
    from fairygen_tpu_torch.ops.fused_norms import fused_rms_modulate, rms_modulate_plain

    b, _, d = shape
    x = _randn(card, *shape).to(dtype)
    w = _randn(card, d).to(dtype)
    sc = (1 + _randn(card, b, 1, d, scale=0.3)).to(dtype) if with_scale else None
    out = fused_rms_modulate(x, w, sc, 1e-5)
    ref = rms_modulate_plain(x, w, sc, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    lo, hi = _k9_bracket(x, w, sc, 1e-5)
    assert _inside(ref, lo, hi) and _inside(out, lo, hi)


@pytest.mark.parametrize("rows,c,dtype,silu", [
    (6240, 256, torch.bfloat16, True), (7800, 1024, torch.bfloat16, True),
    (7800, 1024, torch.bfloat16, False), (600, 512, torch.float32, True),
    (512, 2048, torch.bfloat16, False)])
def test_k11_matches_plain(card, rows, c, dtype, silu):
    from fairygen_tpu_torch.ops.fused_norms import fused_vae_rms_silu, vae_rms_silu_plain

    x = _randn(card, rows, c).to(dtype)
    gamma = (1 + _randn(card, c, scale=0.3)).to(dtype)
    out = fused_vae_rms_silu(x, gamma, silu)
    ref = vae_rms_silu_plain(x, gamma, silu)
    assert out.dtype == dtype and out.shape == x.shape
    lo, hi = _k11_bracket(x, gamma, silu)
    assert _inside(ref, lo, hi) and _inside(out, lo, hi)


def test_k9_k11_refuse_what_they_do_not_take(card):
    from fairygen_tpu_torch.ops.fused_norms import fused_rms_modulate, fused_vae_rms_silu

    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_rms_modulate(_randn(card, 1, 256, 128).half(), _randn(card, 128))
    with pytest.raises(ValueError, match="C <= 2048"):
        fused_vae_rms_silu(_randn(card, 512, 4096), _randn(card, 4096))


def test_tiny_z_image_pipeline_launches_its_kernels(card):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.models.z_image.dit import ZImageDiTConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.z_image import ZImagePipeline

    cfg = ZImageDiTConfig(dim=256, num_heads=2, cap_feat_dim=64, num_layers=2,
                          num_refiner_layers=1)
    vae_cfg = AutoencoderKLConfig(latent_channels=16, block_out_channels=(32, 32, 32, 32),
                                  norm_num_groups=8, scaling_factor=0.3611,
                                  shift_factor=0.1159, use_quant_conv=False)
    pipe = ZImagePipeline(convert.init_z_image_dit_params(cfg), cfg,
                          convert.init_autoencoder_kl_params(vae_cfg), vae_cfg)
    _kernels.reset_launches()
    # 32 x 32 latents: 256 image tokens; 40 caption tokens padded to 64
    img = pipe(prompt_emb=_randn(card, 1, 40, 64), height=256, width=256,
               num_inference_steps=2, seed=1, output_type="floatpoint")
    assert torch.isfinite(img).all() and img.shape == (1, 3, 256, 256)
    sweeps = 2
    got = {k: v for k, v in _kernels.launches.items() if v}
    # K9: 4 per block on the image (256 rows) and unified (320 rows) streams;
    # the 64 caption rows take the plain formula.  Every stream pads to one
    # k tile of 1024, so the attention is K4 throughout
    assert got == {"rms_modulate": 4 * (1 + 2) * sweeps, "rms_rope_per_head": 2 * 4 * sweeps,
                   "flash_small_kv": 4 * sweeps}


def _heads(card, bn, s, d, scale=1.0):
    return _randn(card, bn, s, d, scale=scale)


def _k4_inputs(card, bn, sq, sk_pad, d):
    """Head-major q (sq rows, zero-padded to a multiple of 64) and k, v of
    sk_pad non-zero rows: the masked key rows hold values, as a caller's
    kv_len leaves them."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh = torch.zeros((bn, fa._pad_len(sq, 64, True), d), dtype=torch.bfloat16, device="cuda")
    qh[:, :sq] = _heads(card, bn, sq, d, scale=d ** -0.5 * 1.4427)
    return qh, _heads(card, bn, sk_pad, d), _heads(card, bn, sk_pad, d)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk_pad,sk_actual", [(4096, 128, 77), (1024, 1024, 1024),
                                                 (320, 320, 250), (300, 128, 77),
                                                 (1024, 192, 192), (1024, 1024, 1000),
                                                 (1024, 128, 80), (300, 64, 64)])
def test_k4_max_and_masked_forms_match_plain(card, d, sq, sk_pad, sk_actual):
    """K4's max form (sk_actual == Sk_pad) and masked form against the plain
    version: p is rounded to bf16 against the same row max on both sides,
    so outputs differ by sums in other orders only: 2^-7 relative + 1e-3
    absolute, the tolerance of K3/K4's bounded form, and a relative L2
    error of o below 2^-10, which a kernel rounding p against a running
    max exceeds (tests/test_torch_small_kv_tiles.py).  The masked key rows
    hold non-zero values, as a caller's kv_len leaves them.  sq 300 pads to
    320 (a half q tile); at 192 keys the second 128-key box reads 64 zero
    rows past Sk_pad, which must not enter the max or the sum; 80 and 64
    keys take the 80-column form at head dim 64 (64: a box past Sk_pad)."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh = _k4_inputs(card, 4, sq, sk_pad, d)
    _kernels.reset_launches()
    out = fa.flash_small_kv_max(qh, kh, vh, sk_actual=sk_actual)
    form = "flash_small_kv_masked" if sk_actual < sk_pad else "flash_small_kv_max"
    assert {k: v for k, v in _kernels.launches.items() if v} == {form: 1}
    ref = fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=sk_actual)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel_l2 < 2 ** -10, f"relative L2 error of o {rel_l2:.3e}"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sk_pad,sk_actual", [(128, 77), (128, 128)])
def test_k4_one_key_tile_over_many_heads_matches_plain(card, d, sk_pad, sk_actual):
    """One key tile (SDXL's 77 text keys; 128 keys, the max form) over 40
    heads of 1024 queries: 320 items, more than the card's SMs, so a CTA
    runs two or three items in a row, each item's store under the next
    one's products.  Tolerances as above."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh = _k4_inputs(card, 40, 1024, sk_pad, d)
    out = fa.flash_small_kv_max(qh, kh, vh, sk_actual=sk_actual)
    ref = fa.flash_small_kv_max_plain(qh, kh, vh, sk_actual=sk_actual)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel_l2 < 2 ** -10, f"relative L2 error of o {rel_l2:.3e}"


@pytest.mark.parametrize("d,bn,sq,sk_pad,sk_actual", [(64, 4, 1024, 1024, 1000),
                                                      (128, 4, 300, 512, 512),
                                                      (64, 40, 1024, 128, 77)])
def test_k4_two_launches_give_the_same_bits(card, d, bn, sq, sk_pad, sk_actual):
    """K4 sums in a fixed order (no atomics): two launches on the same
    inputs give the same bits."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    qh, kh, vh = _k4_inputs(card, bn, sq, sk_pad, d)
    first = fa.flash_small_kv_max(qh, kh, vh, sk_actual=sk_actual)
    assert torch.equal(first, fa.flash_small_kv_max(qh, kh, vh, sk_actual=sk_actual))


@pytest.mark.parametrize("sq,sk,kv_len", [(4096, 4096, None), (1100, 1100, 1050)])
def test_k5_at_head_dim_64_matches_plain(card, sq, sk, kv_len):
    """K5 rounds p against its key tile's running max: 2^-7 relative +
    2^-8 absolute, as at head dim 128."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    bn, d = 4, 64
    qh = _heads(card, bn, fa._pad_len(sq, 1024, True), d, scale=d ** -0.5 * 1.4427)
    kh = _heads(card, bn, fa._pad_len(sk, 1024, True), d)
    vh = _heads(card, bn, kh.shape[1], d)
    ska = sk if kv_len is None else kv_len
    _kernels.reset_launches()
    out = fa.flash_fwd(qh, kh, vh, sk_actual=ska, with_lse=False)
    assert {k: v for k, v in _kernels.launches.items() if v} == {"flash_fwd_d64": 1}
    ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=ska, with_lse=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=2 ** -8)


def test_k5_at_head_dim_64_ragged_edges_match_plain(card):
    """sq = 300 (padded to 320: a half q tile) and sk_actual = 4000 of 4096
    non-zero keys: the keys past sk_actual in the last tile are real values
    and must be masked, not counted as zero rows.  One launch, counted
    under flash_fwd_d64; tolerance as at head dim 128."""
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.ops import flash_attention as fa

    bn, d = 4, 64
    qh = _heads(card, bn, fa._pad_len(300, 64, True), d, scale=d ** -0.5 * 1.4427)
    kh, vh = _heads(card, bn, 4096, d), _heads(card, bn, 4096, d)
    _kernels.reset_launches()
    out = fa.flash_fwd(qh, kh, vh, sk_actual=4000, with_lse=False)
    assert {k: v for k, v in _kernels.launches.items() if v} == {"flash_fwd_d64": 1}
    ref = fa.flash_fwd_plain(qh, kh, vh, sk_actual=4000, with_lse=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=2 ** -8)


def test_flash_kernels_refuse_what_they_do_not_take(card):
    """No fallback on the card: fp32 or a head dim outside {64, 128} raises
    for K4's max/masked forms and K5; K6a-c take head dim 128 only."""
    from fairygen_tpu_torch.ops import flash_attention as fa

    def qkv(d, dtype=torch.bfloat16, s=128):
        return [_heads(card, 2, s, d).to(dtype) for _ in range(3)]

    for d, dtype in ((64, torch.float32), (96, torch.bfloat16), (128, torch.float32)):
        with pytest.raises(ValueError):
            fa.flash_small_kv_max(*qkv(d, dtype), sk_actual=100)
        with pytest.raises(ValueError):
            fa.flash_fwd(*qkv(d, dtype), sk_actual=128, with_lse=False)
    with pytest.raises(ValueError, match="1024"):
        fa.flash_small_kv_max(*qkv(64, s=1088), sk_actual=1088)
    q, k, v = qkv(64)
    rows = torch.zeros((2, 128), device="cuda")
    with pytest.raises(ValueError, match="128"):
        fa.flash_fwd(q, k, v, sk_actual=128)
    with pytest.raises(ValueError, match="128"):
        fa.flash_bwd_dq(q, k, v, q, rows, rows, sk_actual=128, dq_factor=1.0)
    with pytest.raises(ValueError, match="128"):
        fa.flash_bwd_dkv(q, k, v, q, rows, rows, sq=128, sk_actual=128)
    with pytest.raises(ValueError):
        fa.flash_attention(*(t.float().reshape(1, 256, 1, 64) for t in (q, k, v)))


def test_tiny_sdxl_brushnet_pipeline_launches_its_kernels(card):
    """Head dim 64 (channels 64 and 128 at 1 and 2 heads), 512x512: the
    64x64 latent's 4096-token self-attention takes K5, the 32x32 one's
    1024 tokens K4's max form (the BrushNet mid attention too), the 77 text
    keys K4's masked form."""
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.sdxl.unet2d import UNet2DConfig
    from fairygen_tpu_torch.models.sdxl.vae import AutoencoderKLConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.sdxl_brushnet import SDXLBrushNetPipeline
    from fairygen_tpu_torch.training.dora_trainer import add_dora_to_sdxl_unet

    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
              up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
              transformer_layers_per_block=(1, 1), cross_attention_dim=64,
              addition_time_embed_dim=8, projection_class_embeddings_input_dim=80)
    ucfg = UNet2DConfig(**kw)
    bcfg = UNet2DConfig(**{**kw, "down_block_types": ("DownBlock2D",) * 2,
                           "up_block_types": ("UpBlock2D",) * 2, "mid_block_type": "UNetMidBlock2D",
                           "attention_head_dim": 64, "conditioning_channels": 5})
    vcfg = AutoencoderKLConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8)
    unet = add_dora_to_sdxl_unet(convert.init_unet2d_params(ucfg, seed=1), card, rank=4)
    pipe = SDXLBrushNetPipeline(unet, ucfg, convert.init_autoencoder_kl_params(vcfg, seed=2),
                                vcfg, convert.init_unet2d_params(bcfg, seed=3, brushnet=True),
                                bcfg, dtype=torch.bfloat16)
    img = torch.rand((512, 512, 3), generator=card, device="cuda").cpu().numpy()
    mask = (torch.rand((512, 512, 1), generator=card, device="cuda") > 0.5).float().cpu().numpy()
    _kernels.reset_launches()
    # pooled 32 + 6 time ids x 8 = the add embedding's 80 inputs
    out = pipe(prompt_embeds=_randn(card, 1, 77, 64), pooled_embeds=_randn(card, 1, 32),
               negative_prompt_embeds=_randn(card, 1, 77, 64),
               negative_pooled_embeds=_randn(card, 1, 32), image=img, mask=mask, height=512,
               width=512, num_inference_steps=2, output_type="np_pm1")
    assert torch.isfinite(out).all() and out.shape == (1, 3, 512, 512)
    steps = 2
    # UNet: 2 + 3 transformer blocks at 64x64, 2 + 1 (mid) + 3 at 32x32
    got = {k: v for k, v in _kernels.launches.items() if v}
    assert got == {"flash_fwd_d64": 5 * steps, "flash_small_kv_max": (6 + 1) * steps,
                   "flash_small_kv_masked": 11 * steps}


def _tiny_vae(seed=0):
    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.models.wan.vae import WanVAEConfig

    cfg = WanVAEConfig.tiny()
    return convert.init_vae_params(cfg, "cpu", torch.float32, seed=seed), cfg


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_streamed_decode_matches_full_sequence(card):
    """fp32 on the card (TF32 off): the streamed decode of 5 latent frames
    against the full-sequence decode and against the CPU's streamed decode.
    cuDNN may pick other convolution algorithms for 1- and 4-frame chunks
    than for the whole clip, so 1e-4 (the CPU tests hold 1e-5)."""
    from fairygen_tpu_torch.models.wan.vae import vae38_decode

    params, cfg = _tiny_vae()
    z = torch.randn((1, 4, 5, 16, 16), generator=torch.Generator().manual_seed(1))
    gp, gz = _to(params, "cuda"), z.cuda()
    streamed = vae38_decode(gp, cfg, gz, streaming=True, clamp=False)
    full = vae38_decode(gp, cfg, gz, clamp=False)
    assert streamed.shape == (1, 3, 17, 256, 256)
    torch.testing.assert_close(streamed, full, rtol=0, atol=1e-4)
    cpu = vae38_decode(params, cfg, z, streaming=True, clamp=False)
    torch.testing.assert_close(streamed.cpu(), cpu, rtol=0, atol=1e-4)
    two = vae38_decode(gp, cfg, gz, streaming=True, clamp=False, frames_per_chunk=2)
    torch.testing.assert_close(two, full, rtol=0, atol=1e-4)


def test_tiled_decode_over_four_tiles_matches_the_cpu(card):
    """12 x 12 latents in 8 x 8 tiles at stride 4 (four tiles, fp32 blend on
    the card) against the same on the CPU: 1e-4, as above."""
    from fairygen_tpu_torch.models.wan.vae_tiling import _tile_tasks, vae38_tiled_decode

    params, cfg = _tiny_vae(2)
    z = torch.randn((1, 4, 3, 12, 12), generator=torch.Generator().manual_seed(3))
    kw = dict(tile_size=(8, 8), tile_stride=(4, 4))
    assert len(_tile_tasks(12, 12, (8, 8), (4, 4))) == 4
    out = vae38_tiled_decode(_to(params, "cuda"), cfg, z.cuda(), **kw)
    assert out.is_cuda and out.dtype == torch.float32 and out.shape == (1, 3, 9, 192, 192)
    torch.testing.assert_close(out.cpu(), vae38_tiled_decode(params, cfg, z, **kw),
                               rtol=0, atol=1e-4)


def test_hot_lora_runs_through_the_serving_kernels(card):
    """A tiny pipeline with a rank-4 hot LoRA (loaded twice: rank 8) on the
    card in bf16 launches K1-K4 as without one, and its latents are held
    to the CPU's in fp32 within twice the CPU bf16 run's relative L2 error
    plus 1e-3 (chip_smoke.py's reference bound); after clear_lora no
    adapter is left."""
    import numpy as np

    from fairygen_tpu_torch import convert
    from fairygen_tpu_torch.core.params import cast_tree
    from fairygen_tpu_torch.models.wan.dit import WanDiTConfig
    from fairygen_tpu_torch.ops import _kernels
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

    cfg = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=32, freq_dim=32,
                       num_heads=2, num_layers=2, seperated_timestep=True,
                       require_vae_embedding=False, require_clip_embedding=False,
                       fuse_vae_embedding_in_latents=True)
    dit = convert.init_dit_params(cfg, "cpu", torch.float32, seed=4)
    vae, vcfg = _tiny_vae(5)
    rng = np.random.default_rng(6)
    lora = {}
    for i in range(2):
        for layer, (d_in, d_out) in (("self_attn.k", (256, 256)), ("ffn.2", (512, 256))):
            lora[f"blocks.{i}.{layer}.lora_A.weight"] = (0.05 * rng.standard_normal(
                (4, d_in))).astype(np.float32)
            lora[f"blocks.{i}.{layer}.lora_B.weight"] = (0.05 * rng.standard_normal(
                (d_out, 4))).astype(np.float32)
    g = torch.Generator().manual_seed(7)
    ctx, nctx = torch.randn(1, 20, 32, generator=g), torch.randn(1, 20, 32, generator=g)
    kw = dict(input_image=np.random.default_rng(8).integers(0, 256, (512, 512, 3), np.uint8),
              seed=9, height=512, width=512, num_frames=17, num_inference_steps=2,
              output_type="latents", torch_compat_noise=True)
    outs = {}
    for dev, dt in (("cpu", torch.float32), ("cpu", torch.bfloat16), ("cuda", torch.bfloat16)):
        pipe = WanVideoPipeline(cast_tree(_to(dit, dev), dt), cfg, cast_tree(_to(vae, dev), dt),
                                vcfg, dtype=dt, device=dev)
        pipe.load_lora(lora, alpha=0.5, hotload=True).load_lora(lora, alpha=0.5, hotload=True)
        assert pipe.dit_params["blocks"][1]["ffn"]["fc2"]["lora"]["A"].shape == (512, 8)
        _kernels.reset_launches()
        outs[dev, dt] = pipe(context=ctx, negative_context=nctx, **kw).float().cpu()
        if dev == "cuda":
            sweeps, layers = 4, 2
            assert {k: v for k, v in _kernels.launches.items() if v} == {
                "ln_modulate": 3 * layers * sweeps, "rms_rope_heads_major": 3 * layers * sweeps,
                "flash_bounded": layers * sweeps, "flash_small_kv": layers * sweeps,
                "vae_rms_silu": 13}  # the first-frame encode; latents out, no decode
            pipe.clear_lora()
            assert not any("lora" in blk[sub][p] for blk in pipe.dit_params["blocks"]
                           for sub, p in (("self_attn", "k"), ("ffn", "fc2")))
    ref = outs["cpu", torch.float32]

    def rel(a):
        return ((a - ref).norm() / ref.norm()).item()

    assert rel(outs["cuda", torch.bfloat16]) <= 2 * rel(outs["cpu", torch.bfloat16]) + 1e-3
