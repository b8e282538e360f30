"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version on the card, and a tiny pipeline that
must launch all four.  They skip here when no card is present; on a card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: bf16 outputs, 1 bf16 ulp (<= 2^-7 relative) for K1/K2 and the
same plus 1e-3 absolute for the attention kernels (p is rounded to bf16
before the p·v product on both sides; sums run in other orders).
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
                                 "flash_small_kv": layers * sweeps}
