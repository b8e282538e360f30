"""The port's TI2V WanVideoPipeline against the JAX package's pipeline on
the same converted weights, context, first image and torch-compatible
noise, and against the committed upstream pipeline golden (loaded through
the port's own converters).  fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.wan import dit as jdit
from fairygen_tpu.models.wan.vae import WanVAEConfig as JVAEConfig
from fairygen_tpu.models.wan.vae import convert_vae38_state_dict
from fairygen_tpu.pipelines.wan_video import WanVideoPipeline as JPipeline
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.models.wan.dit import WanDiTConfig, convert_dit_state_dict
from fairygen_tpu_torch.models.wan.vae import WanVAEConfig, convert_vae38_state_dict as t_vae38
from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline

TI2V = dict(seperated_timestep=True, require_clip_embedding=False,
            require_vae_embedding=False, fuse_vae_embedding_in_latents=True)
GOLDEN_DIT = dict(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
                  patch_size=(1, 2, 2), num_heads=4, num_layers=2, **TI2V)
# head dim 128: the port runs K1-K4 (their plain versions on the CPU)
TINY128 = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, text_dim=32, freq_dim=32,
               patch_size=(1, 2, 2), num_heads=2, num_layers=2, **TI2V)


def _golden_sd(g, prefix):
    return {k[len(prefix) + 2:]: g[k] for k in g.files if k.startswith(prefix + "::")}


def _trees(g, dit_kw):
    vae_sd = _golden_sd(g, "vae")
    vae = jax.tree.map(np.asarray, convert_vae38_state_dict(vae_sd, JVAEConfig.tiny()))
    if dit_kw is GOLDEN_DIT:
        dit = jdit.convert_dit_state_dict(_golden_sd(g, "dit"), jdit.WanDiTConfig(**dit_kw))
    else:
        dit = jdit.init_dit_params(jax.random.key(1), jdit.WanDiTConfig(**dit_kw))
        rng = np.random.default_rng(7)
        dit = jax.tree.map(
            lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
            dit)
    return jax.tree.map(np.asarray, dit), vae


def _port_pipe(dit, vae, dit_kw):
    return WanVideoPipeline(convert.from_jax_params(dit, device="cpu"), WanDiTConfig(**dit_kw),
                            convert.from_jax_params(vae, device="cpu"), WanVAEConfig.tiny(),
                            dtype=torch.float32, device="cpu")


def _kwargs(g, height, width):
    img = np.asarray(g["img_uint8"])
    return dict(input_image=img, seed=42, height=height, width=width, num_frames=9,
                cfg_scale=5.0, num_inference_steps=4, sigma_shift=5.0,
                torch_compat_noise=True)


def test_ti2v_matches_golden(goldens):
    """Upstream-composed TI2V denoise (tests/goldens/wan_pipeline.npz) with
    the JAX package's own tolerance (tests/test_wan_pipeline.py)."""
    g = goldens("wan_pipeline")
    pipe = WanVideoPipeline(
        convert_dit_state_dict(_golden_sd(g, "dit"), WanDiTConfig(**GOLDEN_DIT), device="cpu"),
        WanDiTConfig(**GOLDEN_DIT),
        t_vae38(_golden_sd(g, "vae"), WanVAEConfig.tiny(), device="cpu"), WanVAEConfig.tiny(),
        dtype=torch.float32, device="cpu")
    kw = dict(_kwargs(g, 32, 32), context=torch.from_numpy(g["ctx_p"]),
              negative_context=torch.from_numpy(g["ctx_n"]))
    lat = pipe(output_type="latents", **kw)
    np.testing.assert_allclose(lat.numpy(), g["latents_final"], atol=2e-3, rtol=1e-2)
    video = pipe(output_type="floatpoint", **kw)
    np.testing.assert_allclose(video.numpy(), g["video"], atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("height,width", [(32, 32), (64, 96)])
def test_ti2v_matches_jax_pipeline(goldens, height, width):
    """head-dim-128 DiT (so the port goes through K1-K4's glue and plain
    versions), same weights/context/image/noise into both pipelines.  fp32;
    1e-4 for summation order over 4 CFG steps (the latents) and the decode."""
    g = goldens("wan_pipeline")
    dit, vae = _trees(g, TINY128)
    rng = np.random.default_rng(8)
    ctx, nctx = (rng.standard_normal((1, 12, 32)).astype(np.float32) for _ in range(2))
    kw = _kwargs(g, height, width)
    jpipe = JPipeline(dit_params=jax.tree.map(jnp.asarray, dit),
                      dit_cfg=jdit.WanDiTConfig(**TINY128),
                      vae_params=jax.tree.map(jnp.asarray, vae), vae_cfg=JVAEConfig.tiny(),
                      dtype=jnp.float32)
    ref = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(nctx),
                           cfg_merge=False, output_type="floatpoint", **kw))
    ref_lat = np.asarray(jpipe(context=jnp.asarray(ctx), negative_context=jnp.asarray(nctx),
                               cfg_merge=False, output_type="latents", **kw))
    pipe = _port_pipe(dit, vae, TINY128)
    lat = pipe(context=torch.from_numpy(ctx), negative_context=torch.from_numpy(nctx),
               output_type="latents", **kw)
    np.testing.assert_allclose(lat.numpy(), ref_lat, atol=1e-4, rtol=1e-4)
    video = pipe(context=torch.from_numpy(ctx), negative_context=torch.from_numpy(nctx),
                 output_type="floatpoint", **kw)
    assert video.shape == (1, 3, 9, height, width)
    np.testing.assert_allclose(video.numpy(), ref, atol=1e-4, rtol=1e-4)
    frames = pipe(context=torch.from_numpy(ctx), negative_context=torch.from_numpy(nctx),
                  output_type="quantized", **kw)
    assert len(frames) == 9 and frames[0].shape == (height, width, 3)
