"""The port's FLUX.1 modules against the JAX package on shared weights and
against the committed upstream goldens, loaded through the port's own
converters.  fp32 on the CPU.

* the tiny head-dim-128 DiT (so the port takes K1, K7, K8 and K3/K4, and
  K10 with EliGen, through their plain versions) against the JAX forward
  with its Pallas kernels in interpret mode (TPU gates opened) and against
  its default CPU path: atol 2e-4 / rtol 1e-3 (sums in other orders through
  four blocks);
* the goldens at the JAX package's own tolerances (tests/test_flux_dit.py,
  test_flux_eligen.py, test_flux_text.py, test_flux_vae.py).
"""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import fairygen_tpu.ops.fused_norms as j_fused_norms
import fairygen_tpu.ops.fused_qk as j_fused_qk
from fairygen_tpu.diffusion.flow_match import FlowMatchScheduler as JScheduler
from fairygen_tpu.models.flux import dit as jdit
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.diffusion.flow_match import FlowMatchScheduler
from fairygen_tpu_torch.models.flux import dit as tdit
from fairygen_tpu_torch.models.flux import text_encoders as tte
from fairygen_tpu_torch.models.flux import vae as tvae
from fairygen_tpu_torch.ops import _kernels

# the module, not the function fairygen_tpu.ops re-exports under its name
j_attention = importlib.import_module("fairygen_tpu.ops.attention")


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(g, prefix):
    return {k[len(prefix) + 1:]: g[k] for k in g.files if k.startswith(prefix + ".")}


# head dim 128 (dim 256, 2 heads); RoPE axes sum to 128
TINY128 = dict(dim=256, num_heads=2, in_dim=16, context_dim=48, pooled_dim=32,
               time_freq_dim=32, num_double_blocks=2, num_single_blocks=2,
               axes_dim=(16, 56, 56))


def _tiny_inputs(eligen):
    jcfg = jdit.FluxDiTConfig(**TINY128)
    rng = np.random.default_rng(11)
    jp = jdit.init_flux_dit_params(jax.random.key(0), jcfg)
    # perturbed norms so every parameter matters
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                      .astype(np.float32), jp)
    # 32 x 40 latents: 320 image tokens, so K1's gate (S >= 256) opens on
    # the image stream; 20 text tokens take the plain expression
    inputs = dict(latents=rng.standard_normal((1, 4, 32, 40)).astype(np.float32),
                  timestep=np.array([640.0], np.float32),
                  prompt_emb=rng.standard_normal((1, 20, 48)).astype(np.float32),
                  pooled=rng.standard_normal((1, 32)).astype(np.float32),
                  guidance=np.array([3.5], np.float32))
    kw = {}
    if eligen:
        masks = np.zeros((1, 2, 1, 32, 40), np.float32)
        masks[0, 0, 0, :16] = 1
        masks[0, 1, 0, 8:, 20:] = 1
        kw = dict(entity_prompt_emb=rng.standard_normal((1, 2, 20, 48)).astype(np.float32),
                  entity_masks=masks)
    return jcfg, jp, inputs, kw


@pytest.mark.parametrize("eligen", [False, True], ids=["plain", "eligen"])
def test_tiny_dit_matches_jax_kernel_and_eager_paths(eligen):
    jcfg, jp, inp, kw = _tiny_inputs(eligen)
    tcfg = tdit.FluxDiTConfig(**TINY128)
    params = convert.from_jax_params(jp, device="cpu")
    order = ("latents", "timestep", "prompt_emb", "pooled", "guidance")
    out = tdit.flux_dit_forward(params, tcfg, *(_t(inp[k]) for k in order),
                                **{k: _t(v) for k, v in kw.items()}).numpy()
    jargs = (jax.tree.map(jnp.asarray, jp), jcfg) + tuple(jnp.asarray(inp[k]) for k in order)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    eager = np.asarray(jdit.flux_dit_forward(*jargs, **jkw))
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(j_fused_qk, "_on_tpu", lambda: True), \
            mock.patch.object(j_fused_norms, "_on_tpu", lambda: True), \
            mock.patch.object(j_attention, "_on_tpu", lambda: True):
        kern = np.asarray(jdit.flux_dit_forward(*jargs, **jkw))
    assert out.shape == (1, 4, 32, 40)
    np.testing.assert_allclose(out, kern, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(out, eager, atol=2e-4, rtol=1e-3)


def test_tiny_dit_prescaled_matches_folded():
    """Gammas prescaled as the converter does == the fold inside the entries."""
    _, jp, inp, _ = _tiny_inputs(False)
    tcfg = tdit.FluxDiTConfig(**TINY128)
    params = convert.from_jax_params(jp, device="cpu")
    s = tcfg.head_dim ** -0.5 * 1.4426950408889634
    pre = convert.from_jax_params(jp, device="cpu")
    for blk in pre["double_blocks"]:
        blk["attn"]["norm_q_a"] = blk["attn"]["norm_q_a"] * s
        blk["attn"]["norm_q_b"] = blk["attn"]["norm_q_b"] * s
    for blk in pre["single_blocks"]:
        blk["norm_q"] = blk["norm_q"] * s
    args = tuple(_t(inp[k]) for k in ("latents", "timestep", "prompt_emb", "pooled", "guidance"))
    a = tdit.flux_dit_forward(params, tcfg, *args)
    b = tdit.flux_dit_forward(pre, tcfg, *args, prescaled=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5)


def test_dit_unported_inputs_raise():
    _, jp, inp, _ = _tiny_inputs(False)
    params = convert.from_jax_params(jp, device="cpu")
    args = tuple(_t(inp[k]) for k in ("latents", "timestep", "prompt_emb", "pooled", "guidance"))
    with pytest.raises(NotImplementedError, match="controlnet_res"):
        tdit.flux_dit_forward(params, tdit.FluxDiTConfig(**TINY128), *args,
                              controlnet_res=torch.zeros(1))


# ------------------------------------------------------------------ goldens
@pytest.mark.parametrize("prescale,atol", [(False, 2e-4), (True, 5e-4)])
def test_dit_matches_golden(goldens, prescale, atol):
    g = goldens("flux_dit")
    cfg = tdit.FluxDiTConfig.tiny()
    params = tdit.convert_flux_dit_state_dict(_sd(g, "sd"), cfg, prescale=prescale,
                                              device="cpu")
    out = tdit.flux_dit_forward(params, cfg, _t(g["latents"]), _t(g["timestep"]),
                                _t(g["prompt_emb"]), _t(g["pooled"]), _t(g["guidance"]),
                                prescaled=prescale)
    np.testing.assert_allclose(out.numpy(), g["out"], atol=atol, rtol=1e-3)


def test_eligen_matches_golden(goldens):
    g = goldens("flux_eligen")
    cfg = tdit.FluxDiTConfig.tiny()
    params = tdit.convert_flux_dit_state_dict(_sd(g, "dit"), cfg, device="cpu")
    out = tdit.flux_dit_forward(params, cfg, _t(g["latents"]), _t(g["timestep"]),
                                _t(g["prompt_emb"]), _t(g["pooled"]), _t(g["guidance"]),
                                entity_prompt_emb=_t(g["entity_prompt_emb"]),
                                entity_masks=_t(g["entity_masks"]))
    np.testing.assert_allclose(out.numpy(), g["out"], atol=2e-4, rtol=1e-3)


def test_eligen_bias_matches_jax(goldens):
    g = goldens("flux_eligen")
    ref = np.asarray(jdit.eligen_attention_bias(jnp.asarray(g["entity_masks"]), 6, 24))
    out = tdit.eligen_attention_bias(_t(g["entity_masks"]), 6, 24).numpy()
    np.testing.assert_array_equal(out, ref)


T5_CFG = dict(vocab=96, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2,
              num_buckets=8, max_dist=32, shared_pos_bias=True)
CLIP_CFG = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, eos_token_id=99)


def test_t5_v1_1_matches_golden(goldens):
    g = goldens("flux_text")
    cfg = tte.UMT5Config(**T5_CFG)
    params = tte.convert_t5_encoder_state_dict(_sd(g, "t5"), cfg, device="cpu")
    out = tte.umt5_encode(params, cfg, _t(g["t5_ids"]))
    np.testing.assert_allclose(out.numpy(), g["t5_out"], atol=2e-5, rtol=1e-4)
    assert tte.UMT5Config.t5_v1_1_xxl().shared_pos_bias


@pytest.mark.parametrize("which", ["pooled", "hidden"])
def test_clip_matches_golden(goldens, which):
    g = goldens("flux_text")
    cfg = tte.CLIPTextConfig.tiny(**CLIP_CFG)
    params = tte.convert_flux_clip_state_dict(_sd(g, "clip"), cfg, device="cpu")
    if which == "pooled":
        out, ref = tte.flux_encode_prompt_clip(params, cfg, _t(g["clip_ids"])), g["clip_pooled"]
    else:
        out = tte.clip_text_encode(params, cfg, _t(g["clip_ids"]))["hidden_states"][-2]
        ref = g["clip_hidden"]
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


VAE_CFG = tvae.AutoencoderKLConfig(latent_channels=4, block_out_channels=(8, 16, 32, 32),
                                   norm_num_groups=4, scaling_factor=0.3611,
                                   shift_factor=0.1159, use_quant_conv=False)


@pytest.mark.parametrize("which", ["encode", "decode"])
def test_vae_matches_golden(goldens, which):
    g = goldens("flux_vae")
    params = tvae.convert_flux_vae_state_dict(_sd(g, "sd"), VAE_CFG, device="cpu")
    if which == "encode":
        mean = tvae.vae_encode(params, VAE_CFG, _t(g["img"])).numpy()
        out, ref = (mean - VAE_CFG.shift_factor) * VAE_CFG.scaling_factor, g["lat"]
    else:
        z = _t(g["z"]) / VAE_CFG.scaling_factor + VAE_CFG.shift_factor
        out, ref = tvae.vae_decode(params, VAE_CFG, z).numpy(), g["out"]
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_autoencoder_kl_with_quant_convs_matches_jax():
    """The SD form (quant convs, 2 stages) on seeded weights against the JAX
    package, encode and decode (fp32, 1e-4 for summation order)."""
    from fairygen_tpu.models.sdxl import vae as jvae

    cfg = tvae.AutoencoderKLConfig.tiny()
    params = convert.init_autoencoder_kl_params(cfg, "cpu", torch.float32, seed=3)

    def to_jax(node, key=None):
        if isinstance(node, dict):
            return {k: to_jax(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [to_jax(v) for v in node]
        a = node.numpy()
        return jnp.asarray(a.transpose(2, 3, 1, 0) if key == "w" and a.ndim == 4 else a)

    jp = to_jax(params)
    img = np.random.default_rng(4).uniform(-1, 1, (1, 3, 32, 24)).astype(np.float32)
    z = tvae.vae_encode(params, cfg, _t(img))
    z_ref = np.asarray(jvae.vae_encode(jp, jvae.AutoencoderKLConfig.tiny(), jnp.asarray(img)))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-4, rtol=1e-4)
    d = tvae.vae_decode(params, cfg, _t(z_ref))
    d_ref = np.asarray(jvae.vae_decode(jp, jvae.AutoencoderKLConfig.tiny(), jnp.asarray(z_ref)))
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("steps,shift", [(4, None), (30, 3.0), (7, 1.5)])
def test_flux_schedule_matches_jax(steps, shift):
    ts = FlowMatchScheduler("FLUX.1").set_timesteps(steps, shift=shift)
    ref = JScheduler("FLUX.1").set_timesteps(steps, shift=shift)
    np.testing.assert_array_equal(ts.sigmas, ref.sigmas)
    np.testing.assert_array_equal(ts.timesteps, ref.timesteps)


def test_cpu_forward_launches_no_kernel():
    _, jp, inp, kw = _tiny_inputs(True)
    params = convert.from_jax_params(jp, device="cpu")
    _kernels.reset_launches()
    tdit.flux_dit_forward(params, tdit.FluxDiTConfig(**TINY128),
                          *(_t(inp[k]) for k in ("latents", "timestep", "prompt_emb", "pooled",
                                                 "guidance")),
                          **{k: _t(v) for k, v in kw.items()})
    assert not any(_kernels.launches.values())
