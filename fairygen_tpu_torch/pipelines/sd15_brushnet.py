"""SD1.5 + BrushNet inpainting (port of fairygen_tpu/pipelines/sd15_brushnet.py
``SD15BrushNetPipeline`` and ``blend_with_original``).

The reference ``StableDiffusionBrushNetPipeline`` as BrushNet's own entry
point ``examples/brushnet/test_brushnet.py`` runs it:

  * one CLIP ViT-L text encoder, its final layer-norm states (768 wide);
  * the mask binarized where its channel sum in [-1, 1] is below 0, and the
    conditioning latents VAE(masked image)·sf beside the nearest-resized mask;
  * per UniPC step one BrushNet sweep and one UNet sweep at CFG batch 2
    (uncond first), the BrushNet features added into the UNet scaled by
    ``brushnet_conditioning_scale`` times the ``control_guidance_start/end``
    schedule;
  * the fp32 VAE decode and, with ``blended``, the original pixels pasted
    back outside a Gaussian-blurred mask.

The JAX package runs the denoise loop in jitted chunks of
``steps_per_dispatch`` steps; the port runs it step by step, eagerly.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.imaging import postprocess_image
from ..core.noise import generate_noise
from ..device import resolve_device
from ..diffusion.unipc import UniPCMultistepScheduler
from ..models.sdxl.clip import CLIPTextConfig, clip_text_encode
from ..models.sdxl.unet2d import UNet2DConfig, brushnet_forward, unet2d_forward
from ..models.sdxl.vae import AutoencoderKLConfig, vae_decode, vae_encode
from .sdxl_brushnet import OUTPUT_TYPES, _nearest_resize, _to_nchw_pm1


class SD15BrushNetPipeline:
    """SD1.5 + BrushNet over port params (see ``convert``): the UNet, the
    VAE, BrushNet and the CLIP ViT-L text encoder (with ``tokenizer``, the
    CLIP tokenizer of ``utils/tokenizer.py``, for string prompts).
    ``device`` defaults to "cuda" and raises without a card unless "cpu" is
    asked for; params must already live there."""

    def __init__(self, unet_params: Any, unet_cfg: UNet2DConfig, vae_params: Any,
                 vae_cfg: AutoencoderKLConfig, brushnet_params: Any = None,
                 brushnet_cfg: Optional[UNet2DConfig] = None, te_params: Any = None,
                 te_cfg: Optional[CLIPTextConfig] = None, tokenizer: Any = None,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.unet_params, self.unet_cfg = unet_params, unet_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.brushnet_params, self.brushnet_cfg = brushnet_params, brushnet_cfg
        self.te_params, self.te_cfg, self.tokenizer = te_params, te_cfg, tokenizer
        self.dtype = dtype

    @torch.no_grad()
    def encode_ids(self, ids):
        """Token ids (B, 77) -> the final layer-norm states (B, 77, 768), not
        SDXL's penultimate ones."""
        ids = torch.as_tensor(ids, device=self.device)
        return clip_text_encode(self.te_params, self.te_cfg, ids)["last_hidden_state"]

    def encode_prompt(self, prompt: str):
        """A prompt string through the tokenizer and the text encoder."""
        if self.tokenizer is None or self.te_params is None:
            raise ValueError("a prompt string needs the tokenizer and the text encoder; or pass "
                             "prompt_embeds")
        return self.encode_ids(self.tokenizer(prompt))

    @torch.no_grad()
    def __call__(self, prompt: Optional[str] = None, negative_prompt: str = "", *,
                 prompt_embeds=None, negative_prompt_embeds=None, image=None, mask=None,
                 height: int = 512, width: int = 512, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, brushnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0, control_guidance_end: float = 1.0,
                 seed: int = 0, blended: bool = False, original_image=None,
                 output_type: str = "np", torch_compat_noise: bool = False):
        """Inpaint (with ``image`` and ``mask``) or generate.  ``image``: the
        masked init image, HWC floats in [0, 1] (or (1, 3, H, W) in [-1, 1]);
        ``mask``: HW(C) floats in [0, 1], 1 = the region to inpaint;
        ``original_image``: the unmasked source for the ``blended`` paste.
        ``output_type``: "latent" (the final latents), "np" (a list of (H, W,
        3) uint8 arrays) or "np_pm1" (the decoded (1, 3, H, W) fp32 image in
        [-1, 1]).  Prompts come as strings or as embeddings (1, 77, 768)."""
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type {output_type!r}: one of {OUTPUT_TYPES}")
        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt)
        if do_cfg and negative_prompt_embeds is None:
            negative_prompt_embeds = self.encode_prompt(negative_prompt)
        dev, dt = self.device, self.dtype

        def on_dev(t):
            return torch.as_tensor(t).to(dev, torch.float32)

        sched = UniPCMultistepScheduler(steps_offset=1).set_timesteps(num_inference_steps)
        sf, f = self.vae_cfg.scaling_factor, self.vae_cfg.downscale_factor
        latents = generate_noise((1, self.vae_cfg.latent_channels, height // f, width // f),
                                 seed=seed, dtype=torch.float32, torch_compat=torch_compat_noise,
                                 device=dev)

        use_brushnet = self.brushnet_params is not None and image is not None
        cond = None
        if use_brushnet:
            img, msk = _to_nchw_pm1(image).to(dev), _to_nchw_pm1(mask).to(dev)
            # 1 = the region to paint: the mask's channel sum below 0 in [-1, 1]
            original_mask = (msk.sum(1, keepdim=True) < 0).float()
            cond_lat = vae_encode(self.vae_params, self.vae_cfg, img.to(dt)).float() * sf
            m = _nearest_resize(original_mask, cond_lat.shape[-2], cond_lat.shape[-1])
            cond = torch.cat([cond_lat, m], 1)
            if do_cfg:
                cond = torch.cat([cond, cond])
            cond = cond.to(dt)
        ehs = on_dev(prompt_embeds)
        if do_cfg:
            ehs = torch.cat([on_dev(negative_prompt_embeds), ehs])
        ehs = ehs.to(dt)

        n = num_inference_steps
        keep = [1.0 - float(i / n < control_guidance_start or (i + 1) / n > control_guidance_end)
                for i in range(n)]
        tables = sched.tables(dev)
        state = sched.init_state(latents.shape, device=dev)
        for i in range(n):
            t = tables["timesteps"][i]
            x_in = (torch.cat([latents, latents]) if do_cfg else latents).to(dt)
            kwargs = {}
            if use_brushnet:
                down, mid, up = brushnet_forward(
                    self.brushnet_params, self.brushnet_cfg, x_in, t, ehs, cond,
                    conditioning_scale=brushnet_conditioning_scale * keep[i])
                kwargs = dict(down_block_add_samples=down, mid_block_add_sample=mid,
                              up_block_add_samples=up)
            noise_pred = unet2d_forward(self.unet_params, self.unet_cfg, x_in, t, ehs,
                                        **kwargs).float()
            if do_cfg:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
            latents, state = UniPCMultistepScheduler.step_from_tables(tables, state, noise_pred,
                                                                      i, latents)
        if output_type == "latent":
            return latents
        image_out = vae_decode(self.vae_params, self.vae_cfg, latents / sf)  # fp32 latents
        if blended and original_image is not None and mask is not None:
            image_out = blend_with_original(image_out, original_image, mask)
        if output_type == "np_pm1":
            return image_out
        return [postprocess_image(fr) for fr in image_out.cpu().numpy()]


def blend_with_original(image_pm1, original_image, mask, blur_kernel: int = 21):
    """The Gaussian-blurred mask paste of test_brushnet.py: the original
    pixels outside the (blur-softened) inpaint region.  ``image_pm1`` (B, 3,
    H, W) in [-1, 1]; ``original_image`` HWC in [0, 1]; ``mask`` HW(C) in
    [0, 1], 1 = inpainted.  Host-side numpy, as in the JAX package; returns
    fp32 on ``image_pm1``'s device."""
    img = torch.as_tensor(image_pm1).float().cpu().numpy()
    orig = _to_nchw_pm1(original_image).numpy()
    m = _to_nchw_pm1(mask).numpy()
    m = (m.sum(1, keepdims=True) > 0).astype(np.float32)  # 1 = the inpainted region
    # a separable Gaussian, sigma from the kernel size as cv2 takes it
    k = blur_kernel
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    xs = np.arange(k) - (k - 1) / 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    pad = k // 2
    mb = np.pad(m, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")
    mb = np.apply_along_axis(lambda a: np.convolve(a, g, mode="valid"), 2, mb)
    mb = np.apply_along_axis(lambda a: np.convolve(a, g, mode="valid"), 3, mb)
    m_soft = 1.0 - (1.0 - m) * (1.0 - mb)
    out = orig * (1.0 - m_soft) + img * m_soft
    return torch.from_numpy(out.astype(np.float32)).to(torch.as_tensor(image_pm1).device)
