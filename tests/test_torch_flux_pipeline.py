"""The port's FluxImagePipeline against the committed upstream pipeline
golden (tests/goldens/flux_pipeline.npz, the JAX package's tolerances in
tests/test_flux_pipeline.py) and against the JAX pipeline on the same
weights and starting latents, with EliGen regions and true CFG.  fp32 on
the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core.imaging import postprocess_image
from fairygen_tpu.models.flux import dit as jdit
from fairygen_tpu.models.flux.text_encoders import clip_text_encode as j_clip
from fairygen_tpu.models.flux.text_encoders import umt5_encode as j_umt5
from fairygen_tpu.pipelines.flux_image import FluxImagePipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.flux import dit as tdit
from fairygen_tpu_torch.models.flux import text_encoders as tte
from fairygen_tpu_torch.models.flux import vae as tvae
from fairygen_tpu_torch.pipelines.flux_image import FluxImagePipeline

VAE_CFG = tvae.AutoencoderKLConfig(latent_channels=4, block_out_channels=(8, 16, 32, 32),
                                   norm_num_groups=4, scaling_factor=0.3611,
                                   shift_factor=0.1159, use_quant_conv=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(g, prefix):
    return {k[len(prefix) + 1:]: g[k] for k in g.files if k.startswith(prefix + ".")}


@pytest.fixture(scope="module")
def golden_pipe():
    g = np.load("tests/goldens/flux_pipeline.npz")
    dit = tdit.convert_flux_dit_state_dict(_sd(g, "dit"), tdit.FluxDiTConfig.tiny(),
                                           device="cpu")
    # the golden holds the decoder; the encoder tensors come from flux_vae
    vae_sd = _sd(g, "vae")
    enc = np.load("tests/goldens/flux_vae.npz")
    vae_sd.update({k[3:]: enc[k] for k in enc.files if k.startswith("sd.encoder.")})
    vae = tvae.convert_flux_vae_state_dict(vae_sd, VAE_CFG, device="cpu")
    pipe = FluxImagePipeline(dit, tdit.FluxDiTConfig.tiny(), vae, VAE_CFG, dtype=torch.float32,
                             device="cpu")
    return g, pipe


def _golden_kw(g):
    return dict(prompt_emb=_t(g["prompt_emb"]), pooled_prompt_emb=_t(g["pooled"]),
                latents=g["lat0"], height=64, width=96, num_inference_steps=4,
                embedded_guidance=3.5)


@pytest.mark.parametrize("cfg_scale,key,atol", [(1.0, "lat_nocfg", 2e-4), (2.5, "lat_cfg", 5e-4)])
def test_latents_match_golden(golden_pipe, cfg_scale, key, atol):
    g, pipe = golden_pipe
    lat = pipe(**_golden_kw(g), cfg_scale=cfg_scale, negative_prompt_emb=_t(g["neg_emb"]),
               negative_pooled_prompt_emb=_t(g["neg_pooled"]), output_type="latent")
    np.testing.assert_allclose(lat.numpy(), g[key], atol=atol, rtol=1e-3)


def test_decode_matches_golden(golden_pipe):
    """uint8 images within one step of rounding, as the JAX test allows."""
    g, pipe = golden_pipe
    img = pipe(**_golden_kw(g))
    assert tuple(img.shape) == (1, 3, 64, 96) and img.dtype == torch.float32
    arr, ref = postprocess_image(img[0].numpy()), postprocess_image(g["img_nocfg"][0])
    assert np.abs(arr.astype(np.int32) - ref.astype(np.int32)).max() <= 1


TINY128 = dict(dim=256, num_heads=2, in_dim=16, context_dim=48, pooled_dim=32,
               time_freq_dim=32, num_double_blocks=1, num_single_blocks=2,
               axes_dim=(16, 56, 56))


@pytest.mark.parametrize("eligen_on_negative", [False, True])
def test_eligen_cfg_matches_jax_pipeline(eligen_on_negative):
    """Head dim 128 (the port's fused entries and K10's plain version) with
    two entity regions and CFG 2, against the JAX pipeline's default CPU
    path on the same weights and starting latents: 2e-4 / 1e-3."""
    rng = np.random.default_rng(3)
    jcfg = jdit.FluxDiTConfig(**TINY128)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                      .astype(np.float32), jdit.init_flux_dit_params(jax.random.key(2), jcfg))
    emb, neg = (rng.standard_normal((1, 12, 48)).astype(np.float32) for _ in range(2))
    pooled, neg_pooled = (rng.standard_normal((1, 32)).astype(np.float32) for _ in range(2))
    ent = rng.standard_normal((1, 2, 12, 48)).astype(np.float32)
    masks = np.zeros((1, 2, 1, 16, 24), np.float32)
    masks[0, 0, 0, :, :12] = 1
    masks[0, 1, 0, 4:12, 8:] = 1
    lat0 = rng.standard_normal((1, 4, 16, 24)).astype(np.float32)
    common = dict(cfg_scale=2.0, height=128, width=192, num_inference_steps=2,
                  eligen_enable_on_negative=eligen_on_negative, output_type="latent")
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, jp), dit_cfg=jcfg, dtype=jnp.float32)
    ref = np.asarray(jpipe(prompt_emb=jnp.asarray(emb), pooled_prompt_emb=jnp.asarray(pooled),
                           negative_prompt_emb=jnp.asarray(neg),
                           negative_pooled_prompt_emb=jnp.asarray(neg_pooled), latents=lat0,
                           eligen_entity_prompts=jnp.asarray(ent),
                           eligen_entity_masks=jnp.asarray(masks), **common))
    pipe = FluxImagePipeline(convert.from_jax_params(jp, device="cpu"),
                             tdit.FluxDiTConfig(**TINY128), dtype=torch.float32, device="cpu")
    out = pipe(prompt_emb=_t(emb), pooled_prompt_emb=_t(pooled), negative_prompt_emb=_t(neg),
               negative_pooled_prompt_emb=_t(neg_pooled), latents=lat0,
               eligen_entity_prompts=_t(ent), eligen_entity_masks=_t(masks), **common)
    assert tuple(out.shape) == (1, 4, 16, 24)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_encode_ids_matches_jax_encoders(goldens):
    g = goldens("flux_text")
    t5_cfg = tte.UMT5Config(vocab=96, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
                            num_layers=2, num_buckets=8, max_dist=32, shared_pos_bias=True)
    clip_cfg = tte.CLIPTextConfig.tiny(vocab_size=100, hidden_size=32, intermediate_size=64,
                                       num_layers=2, num_heads=4, eos_token_id=99)
    t5 = tte.convert_t5_encoder_state_dict(_sd(g, "t5"), t5_cfg, device="cpu")
    clip = tte.convert_flux_clip_state_dict(_sd(g, "clip"), clip_cfg, device="cpu")
    pipe = FluxImagePipeline({}, tdit.FluxDiTConfig.tiny(), te_clip_params=clip,
                             te_clip_cfg=clip_cfg, te_t5_params=t5, te_t5_cfg=t5_cfg,
                             dtype=torch.float32, device="cpu")
    emb, pooled = pipe.encode_ids(g["t5_ids"], g["clip_ids"])

    def jtree(tree):
        if isinstance(tree, dict):
            return {k: jtree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [jtree(v) for v in tree]
        return jnp.asarray(tree.numpy())

    from fairygen_tpu.models.flux.text_encoders import UMT5Config as JT5, CLIPTextConfig as JClip

    ref_emb = j_umt5(jtree(t5), JT5(**{f: getattr(t5_cfg, f) for f in t5_cfg.__dataclass_fields__}),
                     jnp.asarray(g["t5_ids"]))
    jclip_cfg = JClip(**{f: getattr(clip_cfg, f) for f in clip_cfg.__dataclass_fields__})
    ref_pooled = j_clip(jtree(clip), jclip_cfg, jnp.asarray(g["clip_ids"]))["pooled"]
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("kw,err", [
    (dict(prompt="a cat"), NotImplementedError),
    (dict(controlnet_inputs=[object()]), NotImplementedError),
    (dict(cfg_scale=3.0), ValueError),
    (dict(height=100), ValueError),
    (dict(output_type="pil"), ValueError),
])
def test_unported_and_bad_arguments_raise(golden_pipe, kw, err):
    g, pipe = golden_pipe
    args = dict(prompt_emb=_t(g["prompt_emb"]), pooled_prompt_emb=_t(g["pooled"]),
                num_inference_steps=1, height=64, width=96, output_type="latent")
    args.update(kw)
    with pytest.raises(err):
        pipe(**args)
