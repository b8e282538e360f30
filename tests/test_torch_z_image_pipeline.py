"""The port's ZImagePipeline against the committed upstream pipeline golden
(tests/goldens/z_image_pipeline.npz, the JAX package's tolerances in
tests/test_z_image_pipeline.py) and against the JAX pipeline on the same
weights, image and starting noise with image-to-image and true CFG; the
"Z-Image" schedule and ``add_noise`` against the JAX scheduler.  fp32 on
the CPU unless a test says otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core.imaging import postprocess_image
from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler
from fairygen_tpu.models.flux import vae as jvae
from fairygen_tpu.models.qwen import text_encoder as jqwen
from fairygen_tpu.models.z_image import dit as jdit
from fairygen_tpu.pipelines.z_image import ZImagePipeline as JPipeline
from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
from fairygen_tpu_torch.models.flux import vae as tvae
from fairygen_tpu_torch.models.qwen import text_encoder as tqwen
from fairygen_tpu_torch.models.z_image import dit as tdit
from fairygen_tpu_torch.pipelines.z_image import ZImagePipeline

VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16, 32, 32), norm_num_groups=4,
              scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(g, prefix):
    return {k[len(prefix) + 1:]: g[k] for k in g.files if k.startswith(prefix + ".")}


@pytest.fixture(scope="module")
def golden():
    """The golden's DiT and VAE decoder (the encoder tensors come from
    flux_vae.npz, as the JAX test takes them), as numpy state dicts."""
    g = np.load("tests/goldens/z_image_pipeline.npz")
    vae_sd = _sd(g, "vae")
    enc = np.load("tests/goldens/flux_vae.npz")
    vae_sd.update({k[3:]: enc[k] for k in enc.files if k.startswith("sd.encoder.")})
    return g, _sd(g, "dit"), vae_sd


def _port_pipe(golden, dtype=torch.float32):
    _, dit_sd, vae_sd = golden
    cfg, vae_cfg = tdit.ZImageDiTConfig.tiny(), tvae.AutoencoderKLConfig(**VAE_KW)
    return ZImagePipeline(tdit.convert_z_image_dit_state_dict(dit_sd, cfg, dtype, "cpu"), cfg,
                          tvae.convert_flux_vae_state_dict(vae_sd, vae_cfg, dtype, "cpu"),
                          vae_cfg, dtype=dtype, device="cpu")


def _golden_kw(g):
    return dict(prompt_emb=_t(g["cap"]), negative_prompt_emb=_t(g["neg"]), cfg_scale=2.0,
                latents=g["lat0"], height=128, width=192, num_inference_steps=4)


def test_latents_match_golden(golden):
    g = golden[0]
    lat = _port_pipe(golden)(**_golden_kw(g), output_type="latent")
    np.testing.assert_allclose(lat.numpy(), g["lat_out"], atol=5e-4, rtol=1e-3)


def test_decode_matches_golden(golden):
    """uint8 images within one step of rounding, as the JAX test allows."""
    g = golden[0]
    pipe = _port_pipe(golden)
    arr = pipe(**_golden_kw(g))
    ref = postprocess_image(g["img"][0])
    assert arr.shape == ref.shape == (128, 192, 3) and arr.dtype == np.uint8
    assert np.abs(arr.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    img = pipe(**_golden_kw(g), output_type="floatpoint")
    assert tuple(img.shape) == (1, 3, 128, 192) and img.dtype == torch.float32
    np.testing.assert_array_equal(postprocess_image(img[0].numpy()), arr)
    assert pipe(**_golden_kw(g), output_type="pil").size == (192, 128)


def test_img2img_cfg_matches_jax_pipeline(golden):
    """Image-to-image at strength 0.6 with CFG 2 on the golden's weights,
    the same seeded image and starting noise, against the JAX pipeline
    (its jitted loop): latents within the golden's 5e-4 / 1e-3."""
    g, dit_sd, vae_sd = golden
    jcfg = jdit.ZImageDiTConfig.tiny()
    jvae_cfg = jvae.AutoencoderKLConfig(**VAE_KW)
    jpipe = JPipeline(dit_params=jdit.convert_z_image_dit_state_dict(dit_sd, jcfg),
                      dit_cfg=jcfg, vae_params=jvae.convert_flux_vae_state_dict(vae_sd, jvae_cfg),
                      vae_cfg=jvae_cfg, dtype=jnp.float32)
    image = np.random.default_rng(12).integers(0, 256, (128, 192, 3), dtype=np.uint8)
    kw = dict(input_image=image, denoising_strength=0.6, cfg_scale=2.0, latents=g["lat0"],
              height=128, width=192, num_inference_steps=3, output_type="latent")
    ref = np.asarray(jpipe(prompt_emb=jnp.asarray(g["cap"]),
                           negative_prompt_emb=jnp.asarray(g["neg"]), **kw))
    out = _port_pipe(golden)(prompt_emb=_t(g["cap"]), negative_prompt_emb=_t(g["neg"]), **kw)
    assert tuple(out.shape) == (1, 4, 16, 24)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_encode_ids_is_the_penultimate_qwen3_state():
    gq = np.load("tests/goldens/z_image_text.npz")
    cfg_kw = dict(head_dim_override=8, qk_norm=True, attn_bias=False, num_layers=3)
    sd = _sd(gq, "sd")
    te = tqwen.convert_qwen_vl_text_state_dict(sd, tqwen.QwenVLTextConfig.tiny(**cfg_kw),
                                               device="cpu")
    pipe = ZImagePipeline({}, tdit.ZImageDiTConfig.tiny(), te_params=te,
                          te_cfg=tqwen.QwenVLTextConfig.tiny(**cfg_kw), dtype=torch.bfloat16,
                          device="cpu")
    emb = pipe.encode_ids(gq["ids"][:1])
    ref = jqwen.qwen_vl_text_encode(
        jqwen.convert_qwen_vl_text_state_dict(sd, jqwen.QwenVLTextConfig.tiny(**cfg_kw)),
        jqwen.QwenVLTextConfig.tiny(**cfg_kw), jnp.asarray(gq["ids"][:1]), hidden_state_index=-2)
    # the fp32 states agree to ~1e-7, so their bf16 roundings lie within 1 bf16 ulp
    assert emb.dtype == torch.bfloat16 and tuple(emb.shape) == (1, gq["ids"].shape[1], 32)
    np.testing.assert_allclose(emb.float().numpy(), np.asarray(ref), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(num_inference_steps=8), dict(num_inference_steps=50),
                                dict(num_inference_steps=8, denoising_strength=0.6),
                                dict(num_inference_steps=6, shift=5.0),
                                dict(num_inference_steps=10, target_timesteps=[999.0, 500.0])])
def test_z_image_schedule_matches_jax(kw):
    ts = FlowMatchScheduler("Z-Image").set_timesteps(**kw)
    ref = JScheduler("Z-Image").set_timesteps(**kw)
    np.testing.assert_array_equal(ts.sigmas, ref.sigmas)
    np.testing.assert_array_equal(ts.timesteps, ref.timesteps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_add_noise_matches_jax(dtype):
    """σ rounded to the sample's dtype first, then (1 - σ)·x₀ + σ·ε."""
    rng = np.random.default_rng(7)
    x0, eps = (rng.standard_normal((1, 4, 8, 12)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ts = FlowMatchScheduler("Z-Image").set_timesteps(8, denoising_strength=0.6)
    ref = JScheduler("Z-Image").set_timesteps(8, denoising_strength=0.6)
    for i in (0, 3):
        out = ts.add_noise(_t(x0).to(dtype), _t(eps).to(dtype), i)
        r = ref.add_noise(jnp.asarray(x0, jdt), jnp.asarray(eps, jdt), i)
        assert out.dtype == dtype
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)))


@pytest.mark.parametrize("call,err", [
    (lambda p, kw: p(prompt="a cat", **kw), NotImplementedError),
    (lambda p, kw: p(**kw), NotImplementedError),  # no prompt_emb
    (lambda p, kw: p(prompt_emb=torch.zeros(1, 4, 48), cfg_scale=3.0, **kw), ValueError),
    (lambda p, kw: p(prompt_emb=torch.zeros(1, 4, 48), **dict(kw, output_type="tensor")),
     ValueError),
    (lambda p, kw: p(prompt_emb=torch.zeros(1, 4, 48), **dict(kw, height=100)), ValueError),
    (lambda p, kw: ZImagePipeline.from_pretrained("model.safetensors"), NotImplementedError),
], ids=["string-prompt", "no-prompt-emb", "cfg-without-negative", "output-type", "height",
        "from_pretrained"])
def test_unported_and_bad_arguments_raise(golden, call, err):
    with pytest.raises(err):
        call(_port_pipe(golden), dict(num_inference_steps=1, height=128, width=192,
                                      output_type="latent"))
