"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version on the card, a tiny pipeline that must
launch the four serving kernels, the flash-attention gradient against
autograd of the plain attention, and a tiny LoRA train step that must
launch K6a-c.  They skip here when no card is present; on a card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: bf16 outputs, 1 bf16 ulp (<= 2^-7 relative) for K1/K2 and the
same plus 1e-3 absolute for the attention kernels (p is rounded to bf16
before the p·v product on both sides; sums run in other orders).  K6b/K6c
round P and dS to bf16 before their products on both sides, but at values
that differ in the last fp32 bits (sums in another order), so a term may
move by one bf16 ulp: their gradients are held to 2^-7 relative plus 1e-2
of the largest |gradient|.
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


@pytest.mark.parametrize("sq,sk", [(300, 300), (1100, 1100), (300, 77), (1950, 512)])
def test_k3_k4_match_plain(card, sq, sk):
    from fairygen_tpu_torch.ops import fused_qk as fq
    from fairygen_tpu_torch.ops.flash_attention import (flash_attention_heads_major,
                                                         flash_attention_heads_major_plain)

    b, n = 1, 3
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
    ref = flash_attention_heads_major_plain(qh, kh, v, b=b, n=n, sq=sq, sk_actual=sk)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


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
    assert _kernels.launches == {"ln_modulate": 3 * layers * sweeps,
                                 "rms_rope_heads_major": 3 * layers * sweeps,
                                 "flash_bounded": layers * sweeps,
                                 "flash_small_kv": layers * sweeps,
                                 "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0}


def _close_grad(out, ref):
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -7,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.parametrize("sq,sk,kv_len", [(300, 300, None), (1100, 1100, None),
                                          (300, 77, None), (1950, 512, None),
                                          (700, 700, 650)])
def test_k5_k6_match_plain(card, sq, sk, kv_len):
    from fairygen_tpu_torch.ops import flash_attention as fa

    n = 3
    q = _randn(card, 1, sq, n, 128, scale=128 ** -0.5 * 1.4427)
    k, v, do = _randn(card, 1, sk, n, 128), _randn(card, 1, sk, n, 128), _randn(card, 1, sq, n, 128)
    bq, bk = fa._tiles(sq, sk)
    qh = fa._heads_major(q, fa._pad_len(sq, bq, True))
    kh, vh = (fa._heads_major(t, fa._pad_len(sk, bk, True)) for t in (k, v))
    doh = fa._heads_major(do, qh.shape[1])
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
