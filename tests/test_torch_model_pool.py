"""The port's ModelPool builders of the FLUX.1 and Z-Image families against
the JAX package's.  Each case writes a tiny checkpoint (a committed golden's
state dict, in one of the layouts the builder tells apart) to a safetensors
file and loads it through ``ModelPool.load(hints=)`` in both packages: the
same layout probe, the same converter, the same configuration and every
leaf bit-equal.  A builder constructs its family's published configuration;
here that preset is swapped, in both packages alike, for the tiny
configuration of the golden the checkpoint comes from."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairygen_tpu.core.model_pool import ModelPool as JaxModelPool
from fairygen_tpu.models.flux import dit as jfdit
from fairygen_tpu.models.flux import text_encoders as jfte
from fairygen_tpu.models.qwen import text_encoder as jqwen
from fairygen_tpu.models.sdxl import vae as jsvae
from fairygen_tpu.models.wan import text_encoder as jte
from fairygen_tpu.models.z_image import dit as jzdit
from fairygen_tpu_torch import convert
from fairygen_tpu_torch.core import io as tio
from fairygen_tpu_torch.core.model_pool import ModelPool
from fairygen_tpu_torch.models.adapters import leaves_with_path
from fairygen_tpu_torch.models.flux import dit as tfdit
from fairygen_tpu_torch.models.flux import vae as tfvae
from fairygen_tpu_torch.models.qwen import text_encoder as tqwen
from fairygen_tpu_torch.models.sdxl import clip as tsclip
from fairygen_tpu_torch.models.sdxl import vae as tsvae
from fairygen_tpu_torch.models.wan import text_encoder as tte
from fairygen_tpu_torch.models.z_image import dit as tzdit
from test_torch_converters import (CLIP_CFG, T5_CFG, _diffusers_and_bfl_vae_names, _sd,
                                   transformers_clip_sd)
from test_torch_z_image_modules import QWEN_GOLDEN_CFG

FLUX_VAE_CFG = dict(latent_channels=4, block_out_channels=(8, 16, 32, 32), norm_num_groups=4,
                    scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False)


def _tiny_presets(monkeypatch):
    """Swap each builder's published preset for the goldens' tiny one, in
    both packages (the names each builder reads when it runs)."""
    # a class the builder calls is replaced by its tiny instance's copy
    for mod, name, tiny in ((tfdit, "FluxDiTConfig", {}), (jfdit, "FluxDiTConfig", {}),
                            (tsclip, "CLIPTextConfig", CLIP_CFG),
                            (jfte, "CLIPTextConfig", CLIP_CFG),
                            (tzdit, "ZImageDiTConfig", {}), (jzdit, "ZImageDiTConfig", {})):
        cfg = getattr(mod, name).tiny(**tiny)
        monkeypatch.setattr(mod, name, lambda cfg=cfg, **kw: dataclasses.replace(cfg, **kw))
    for cls in (tte.UMT5Config, jte.UMT5Config):
        monkeypatch.setattr(cls, "t5_v1_1_xxl", staticmethod(lambda cls=cls: cls(**T5_CFG)))
    for cls in (tsvae.AutoencoderKLConfig, jsvae.AutoencoderKLConfig):
        monkeypatch.setattr(cls, "flux", staticmethod(lambda cls=cls: cls(**FLUX_VAE_CFG)))
    for cls in (tqwen.QwenVLTextConfig, jqwen.QwenVLTextConfig):
        monkeypatch.setattr(cls, "qwen3_4b",
                            staticmethod(lambda cls=cls: cls.tiny(**QWEN_GOLDEN_CFG)))


def _checkpoint(goldens, case):
    """The tiny state dict of ``case``, in the layout the case names."""
    if case == "flux_dit":
        return _sd(goldens("flux_dit"), "sd", ".")
    if case.startswith("flux_text_encoder_clip"):
        sd = _sd(goldens("flux_text"), "clip", ".")
        return transformers_clip_sd(sd) if "transformers" in case else sd
    if case == "flux_text_encoder_t5":
        return _sd(goldens("flux_text"), "t5", ".")
    if case.startswith("flux_vae"):
        sd = _sd(goldens("flux_vae"), "sd", ".")
        if "BFL" not in case:
            return sd
        tree = tfvae.convert_flux_vae_state_dict(sd, tsvae.AutoencoderKLConfig(**FLUX_VAE_CFG),
                                                 device="cpu")
        return _diffusers_and_bfl_vae_names(tree)[1]
    return _sd(goldens("z_image_dit" if case == "z_image_dit" else "z_image_text"), "sd", ".")


CASES = {
    "flux_dit": "flux_dit",
    "flux_text_encoder_clip": "flux_text_encoder_clip",
    "flux_text_encoder_clip (transformers)": "flux_text_encoder_clip",
    "flux_text_encoder_t5": "flux_text_encoder_t5",
    "flux_vae (diffusers)": "flux_vae_encoder",
    "flux_vae (BFL)": "flux_vae_decoder",
    "z_image_dit": "z_image_dit",
    "z_image_text_encoder": "z_image_text_encoder",
}


@pytest.mark.parametrize("case", list(CASES))
def test_builder_matches_the_jax_package(case, goldens, monkeypatch, tmp_path):
    _tiny_presets(monkeypatch)
    name = CASES[case]
    sd = _checkpoint(goldens, case)
    path = str(tmp_path / "ckpt.safetensors")
    tio.save_safetensors(path, sd)
    hints = {path: (name, {})}
    (params, cfg), = ModelPool().load([path], dtype=torch.float32, hints=hints,
                                      device="cpu").models[name]
    (jparams, jcfg), = JaxModelPool().load([path], dtype=jnp.float32, hints=hints).models[name]
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k in dataclasses.asdict(cfg)}
    ref = dict(leaves_with_path(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                                        device="cpu")))
    got = dict(leaves_with_path(params))
    assert got and set(got) == set(ref)
    for key, t in got.items():
        assert t.dtype == ref[key].dtype and t.shape == ref[key].shape, key
        assert torch.equal(t, ref[key]), key
