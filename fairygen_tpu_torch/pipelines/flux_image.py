"""FLUX.1 text-to-image pipeline (port of the t2i path of
fairygen_tpu/pipelines/flux_image.py ``FluxImagePipeline``).

The call: seeded noise (or given ``latents``), the FLUX.1 flow-match
schedule, one DiT sweep per step (two with true CFG, ``cfg_scale`` != 1),
embedded guidance, optional EliGen entity regions, then the fp32 VAE decode
with the (shift, scale) latent normalization.  Prompts arrive as T5 and
CLIP embeddings (:meth:`FluxImagePipeline.encode_ids` runs both encoders on
token ids); the tokenizers need files the repository does not hold.
:meth:`FluxImagePipeline.quantize` swaps the DiT's block projections to
W8A8.  Image-to-image, Kontext, ControlNet, IP-Adapter, LoRA, TeaCache,
tiling and the other extras of the JAX pipeline are not ported and raise.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.noise import generate_noise
from ..core.params import cast_tree
from ..device import resolve_device
from ..diffusion.flow_match import FlowMatchScheduler
from ..models.flux.dit import FluxDiTConfig, flux_dit_forward
from ..models.flux.text_encoders import CLIPTextConfig, UMT5Config, flux_encode_prompt_clip
from ..models.sdxl.vae import AutoencoderKLConfig, vae_decode
from ..models.wan.text_encoder import umt5_encode


class FluxImagePipeline:
    """FLUX.1 over port params (see ``convert``).  ``prescaled``: the DiT's
    q-norm gammas carry hd^-1/2·log2e (``convert_flux_dit_state_dict(...,
    prescale=True)``).  ``device`` defaults to "cuda" and raises without a
    card unless "cpu" is asked for; params must already live there."""

    def __init__(self, dit_params: Any, dit_cfg: FluxDiTConfig, vae_params: Any = None,
                 vae_cfg: Optional[AutoencoderKLConfig] = None, te_clip_params: Any = None,
                 te_clip_cfg: Optional[CLIPTextConfig] = None, te_t5_params: Any = None,
                 te_t5_cfg: Optional[UMT5Config] = None, dtype=torch.bfloat16, device="cuda",
                 prescaled: bool = False):
        self.device = resolve_device(device)
        self.dit_params, self.dit_cfg = dit_params, dit_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.te_clip_params, self.te_clip_cfg = te_clip_params, te_clip_cfg
        self.te_t5_params, self.te_t5_cfg = te_t5_params, te_t5_cfg
        self.dtype, self.prescaled = dtype, prescaled

    def quantize(self):
        """Swap the double- and single-block projections to W8A8
        (``ops/quant.py``); the embedders, the modulation linears and the
        output head stay in their float dtype.  Each float weight is dropped
        as its int8 copy is made."""
        from ..ops.quant import quantize_image_dit_params

        self.dit_params = quantize_image_dit_params(self.dit_params, consume=True)
        return self

    @torch.no_grad()
    def encode_ids(self, t5_ids, clip_ids):
        """T5 ids (B, L) and CLIP ids (B, 77) -> (prompt_emb (B, L, 4096),
        pooled (B, 768)) in the pipeline's dtype."""
        t5_ids = torch.as_tensor(t5_ids, device=self.device)
        clip_ids = torch.as_tensor(clip_ids, device=self.device)
        emb = umt5_encode(self.te_t5_params, self.te_t5_cfg, t5_ids)
        pooled = flux_encode_prompt_clip(self.te_clip_params, self.te_clip_cfg, clip_ids)
        return emb.to(self.dtype), pooled.to(self.dtype)

    def _sweep(self, x, t, emb, pooled, guidance, entity_emb, entity_masks):
        return flux_dit_forward(
            self.dit_params, self.dit_cfg, x, t, emb, pooled,
            guidance if self.dit_cfg.guidance_embed else None, prescaled=self.prescaled,
            entity_prompt_emb=entity_emb,
            entity_masks=entity_masks if entity_emb is not None else None)

    @torch.no_grad()
    def __call__(self, prompt=None, *, prompt_emb=None, pooled_prompt_emb=None,
                 negative_prompt_emb=None, negative_pooled_prompt_emb=None,
                 cfg_scale: float = 1.0, embedded_guidance: float = 3.5, height: int = 1024,
                 width: int = 1024, seed: Optional[int] = None,
                 sigma_shift: Optional[float] = None, num_inference_steps: int = 30,
                 latents=None, eligen_entity_prompts=None, eligen_entity_masks=None,
                 eligen_enable_on_negative: bool = False, output_type: str = "floatpoint",
                 **unported):
        """Text to image.  ``output_type``: "latent" (the final latents) or
        "floatpoint" (the decoded (B, 3, H, W) fp32 image in [-1, 1]).
        EliGen: ``eligen_entity_prompts`` (B, N, L, 4096) embeddings and
        ``eligen_entity_masks`` (B, N, 1, H/8, W/8) binary masks."""
        given = sorted(k for k, v in unported.items() if v is not None)
        if prompt is not None or given:
            raise NotImplementedError("string prompts (the tokenizers) and "
                                      f"{given or 'the other extras'} are not ported yet")
        if height % 16 or width % 16:
            raise ValueError(f"height and width must be multiples of 16, got {height}x{width}")
        if output_type not in ("latent", "floatpoint"):
            raise ValueError(f"output_type {output_type!r}: 'latent' or 'floatpoint'")
        do_cfg = cfg_scale != 1.0
        if do_cfg and negative_prompt_emb is None:
            raise ValueError("cfg_scale != 1 needs negative_prompt_emb / "
                             "negative_pooled_prompt_emb (the encoded negative prompt)")
        sched = FlowMatchScheduler("FLUX.1").set_timesteps(num_inference_steps,
                                                           shift=sigma_shift)
        timesteps = torch.tensor(sched.timesteps, dtype=torch.float32, device=self.device)
        dev, dt = self.device, self.dtype
        prompt_emb, pooled_prompt_emb = prompt_emb.to(dev, dt), pooled_prompt_emb.to(dev, dt)
        if do_cfg:
            negative_prompt_emb = negative_prompt_emb.to(dev, dt)
            negative_pooled_prompt_emb = negative_pooled_prompt_emb.to(dev, dt)
        zc = self.vae_cfg.latent_channels if self.vae_cfg else self.dit_cfg.in_dim // 4
        if latents is not None:
            x = torch.as_tensor(latents).to(dev, dt)
        else:
            x = generate_noise((1, zc, height // 8, width // 8), seed=0 if seed is None else seed,
                               dtype=dt, device=dev)
        guidance = torch.full((1,), embedded_guidance, dtype=torch.float32, device=dev)

        entity_emb = entity_masks = entity_emb_neg = None
        if eligen_entity_prompts is not None:
            entity_emb = torch.as_tensor(eligen_entity_prompts).to(dev, dt)
            entity_masks = torch.as_tensor(eligen_entity_masks).to(dev, dt)
            if eligen_enable_on_negative and do_cfg:
                # the negative prompt repeated once per entity
                entity_emb_neg = negative_prompt_emb[:, None].expand(
                    -1, entity_emb.shape[1], -1, -1)

        scale = torch.tensor(cfg_scale, dtype=torch.float32).to(dt)
        for i in range(len(sched.timesteps)):
            t = timesteps[i].expand(x.shape[0])
            v = self._sweep(x, t, prompt_emb, pooled_prompt_emb, guidance, entity_emb,
                            entity_masks)
            if do_cfg:
                v_n = self._sweep(x, t, negative_prompt_emb, negative_pooled_prompt_emb,
                                  guidance, entity_emb_neg, entity_masks)
                v = v_n + scale.to(v.device, v.dtype) * (v - v_n)
            x = sched.step(v, i, x)
        if output_type == "latent":
            return x
        # fp32 decode of the (shift, scale)-normalized latents
        z = x.float() / self.vae_cfg.scaling_factor + self.vae_cfg.shift_factor
        return vae_decode(cast_tree(self.vae_params, torch.float32), self.vae_cfg, z)
