"""The port's SDXLBrushNetPipeline against the committed upstream golden
(tests/goldens/brushnet_pipeline.npz: 64x64, 6 DPM-Solver++ steps, CFG
7.5, BrushNet scale 0.7, seed 77 with torch-compatible noise; the JAX
suite's bar in tests/test_brushnet_pipeline.py: every pixel within 3
levels and PSNR above 45 dB) and against the JAX pipeline on the same
weights with a style DoRA loaded at scale 0.66 (2 steps, the decoded
image in [-1, 1]).  fp32 on the CPU.  Also the parts of the call that are
not ported raise, and the helpers match the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.models.sdxl import unet2d as junet
from fairygen_tpu.models.sdxl import vae as jvae
from fairygen_tpu.pipelines import sdxl_brushnet as jpipe
from fairygen_tpu.training import dora_trainer as jdora
from fairygen_tpu_torch.models.sdxl import unet2d as tunet
from fairygen_tpu_torch.models.sdxl import vae as tvae
from fairygen_tpu_torch.pipelines import sdxl_brushnet as tpipe
from fairygen_tpu_torch.training import dora_trainer as tdora

UNET_KW = dict(block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                                                              "CrossAttnDownBlock2D"),
               up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
               transformer_layers_per_block=(1, 2), num_attention_heads=(2, 4),
               cross_attention_dim=32, norm_num_groups=16, addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=80)
BN_KW = dict(UNET_KW, down_block_types=("DownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "UpBlock2D"), mid_block_type="UNetMidBlock2D",
             transformer_layers_per_block=(0, 0), attention_head_dim=8, conditioning_channels=5)


def _sd(g, prefix):
    n = len(prefix) + 2
    return {k[n:]: g[k] for k in g.files if k.startswith(prefix + "::")}


@pytest.fixture(scope="module")
def g():
    return np.load("tests/goldens/brushnet_pipeline.npz")


def _port_pipe(g, dora_sd=None):
    ucfg, bcfg = tunet.UNet2DConfig(**UNET_KW), tunet.UNet2DConfig(**BN_KW)
    vcfg = tvae.AutoencoderKLConfig.tiny()
    unet = tunet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg, device="cpu")
    if dora_sd is not None:
        unet, _ = tdora.load_sdxl_dora_state_dict(unet, dora_sd, scale=0.66)
    return tpipe.SDXLBrushNetPipeline(
        unet, ucfg, tvae.convert_autoencoder_kl_state_dict(_sd(g, "vae"), vcfg, device="cpu"),
        vcfg, tunet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg, device="cpu"), bcfg,
        device="cpu")


def _call_kw(g, **over):
    kw = dict(prompt_embeds=g["pe"], pooled_embeds=g["ppe"], negative_prompt_embeds=g["npe"],
              negative_pooled_embeds=g["nppe"], image=g["masked_u8"].astype(np.float32) / 255.0,
              mask=g["mask_u8"].astype(np.float32) / 255.0, height=64, width=64,
              num_inference_steps=6, guidance_scale=7.5, brushnet_conditioning_scale=0.7,
              seed=77, torch_compat_noise=True)
    kw.update(over)
    return kw


def test_brushnet_pipeline_matches_golden(g):
    frames = _port_pipe(g)(**_call_kw(g))
    ours = frames[0].astype(np.float32)
    ref = g["img_out"] * 255.0
    assert ours.shape == ref.shape == (64, 64, 3) and frames[0].dtype == np.uint8
    diff = np.abs(ours - ref)
    assert diff.max() <= 3, f"max pixel diff {diff.max()}"
    psnr = 10 * np.log10(255.0 ** 2 / max(np.mean((ours - ref) ** 2), 1e-9))
    assert psnr > 45, f"PSNR {psnr:.1f} dB"


def test_pipeline_with_dora_matches_jax(g):
    ucfg, bcfg = junet.UNet2DConfig(**UNET_KW), junet.UNet2DConfig(**BN_KW)
    vcfg = jvae.AutoencoderKLConfig.tiny()
    unet = junet.convert_unet2d_state_dict(_sd(g, "unet"), ucfg)
    sd = jdora.sdxl_dora_state_dict(jdora.add_dora_to_sdxl_unet(
        unet, jax.random.key(1), rank=4))
    rng = np.random.default_rng(1)
    for k in sd:
        if k.endswith(".lora_B.weight"):
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    unet, n = jdora.load_sdxl_dora_state_dict(unet, sd, scale=0.66)
    assert n > 0
    jp = jpipe.SDXLBrushNetPipeline(
        unet_params=unet, unet_cfg=ucfg,
        vae_params=jvae.convert_autoencoder_kl_state_dict(_sd(g, "vae"), vcfg), vae_cfg=vcfg,
        brushnet_params=junet.convert_unet2d_state_dict(_sd(g, "bn"), bcfg), brushnet_cfg=bcfg)
    kw = _call_kw(g, num_inference_steps=2, output_type="np_pm1")
    ref = jp(**{k: jnp.asarray(v) if k.endswith("embeds") else v for k, v in kw.items()})
    out = _port_pipe(g, sd)(**kw)
    assert tuple(out.shape) == (1, 3, 64, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("bad", [dict(prompt="a castle", prompt_embeds=None),
                                 dict(output_type="pil"), dict(negative_prompt_embeds=None)])
def test_unported_parts_raise(g, bad):
    """A mesh is not ported; a prompt string (or CFG without negative
    embeddings) needs the tokenizers and text encoders, which this pipeline
    lacks; an output type it does not know raises.  (The LCM rollout, which
    raised here before, is held against the JAX pipeline in
    tests/test_torch_sdxl_training.py.)"""
    with pytest.raises(ValueError):
        _port_pipe(g)(**_call_kw(g, **bad))
    with pytest.raises(NotImplementedError, match="mesh"):
        tpipe.SDXLBrushNetPipeline({}, None, {}, None, device="cpu", mesh=object())


def test_helpers_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((12, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpipe._to_nchw_pm1(img).numpy(),
                                  np.asarray(jpipe._to_nchw_pm1(img)))
    m = rng.random((12, 10)).astype(np.float32)
    np.testing.assert_array_equal(tpipe._to_nchw_pm1(m).numpy(),
                                  np.asarray(jpipe._to_nchw_pm1(m, channels=None)))
    x = rng.random((1, 1, 12, 10)).astype(np.float32)
    np.testing.assert_array_equal(tpipe._nearest_resize(torch.from_numpy(x), 5, 4).numpy(),
                                  np.asarray(jpipe._nearest_resize(jnp.asarray(x), 5, 4)))
    tree = {"a": {"w": torch.ones(2), "lora": {"A": torch.ones(2, 1), "scale": 0.5}}}
    out = tpipe.scale_adapters(tree, 0.66)
    assert out["a"]["lora"]["scale"] == pytest.approx(0.33) and out["a"]["w"] is tree["a"]["w"]
    assert tree["a"]["lora"]["scale"] == 0.5
