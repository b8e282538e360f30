"""SDXL + BrushNet stylization (port of fairygen_tpu/pipelines/sdxl_brushnet.py
``SDXLBrushNetPipeline`` with ``scale_adapters``, ``_to_nchw_pm1`` and
``_nearest_resize``).

The call: seeded noise, the masked image through the VAE encoder (times
the scaling factor) beside the nearest-resized background mask as
BrushNet's conditioning latents, then per DPM-Solver++(2M) step one
BrushNet sweep and one UNet sweep at CFG batch 2 (uncond first), the
BrushNet features added into the UNet scaled by ``brushnet_conditioning_scale``
times the ``brushnet_keep`` schedule, and the fp32 VAE decode.  The style
DoRA rides inside the UNet params; ``scale_adapters`` rescales it.
Prompts arrive as embeddings; :meth:`SDXLBrushNetPipeline.encode_ids` runs
the two CLIP encoders on token ids in place of the JAX package's
tokenizers, which need files the repository does not hold.  String
prompts, ``scheduler="lcm"`` and a device ``mesh`` are not ported and
raise.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.imaging import postprocess_image
from ..core.noise import generate_noise
from ..core.params import cast_tree
from ..device import resolve_device
from ..diffusion.dpm_solver import DPMSolverMultistepScheduler
from ..models.adapters import map_with_path
from ..models.sdxl.clip import CLIPTextConfig, sdxl_encode_prompt
from ..models.sdxl.unet2d import UNet2DConfig, brushnet_forward, unet2d_forward
from ..models.sdxl.vae import AutoencoderKLConfig, vae_decode, vae_encode

OUTPUT_TYPES = ("latent", "np", "np_pm1")


def scale_adapters(params, scale: float):
    """A tree whose every adapter ``scale`` is multiplied by ``scale`` (the
    ``lora_scale`` of a call); other leaves are shared."""
    def fn(path, leaf):
        return leaf * scale if "lora" in path and path[-1] == "scale" else leaf

    return map_with_path(fn, params)


def _to_nchw_pm1(x):
    """HWC (or HW) in [0, 1] -> (1, C, H, W) fp32 in [-1, 1]; a 4-D input
    is taken as already normalized NCHW."""
    x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x).float()
    if x.dim() == 4:
        return x
    if x.dim() == 2:
        x = x[:, :, None]
    return x.permute(2, 0, 1)[None] * 2.0 - 1.0


def _nearest_resize(x, h, w):
    """(B, C, H, W) nearest resize (torch ``F.interpolate`` 'nearest')."""
    H, W = x.shape[-2:]
    ih = torch.arange(h, device=x.device) * H // h
    iw = torch.arange(w, device=x.device) * W // w
    return x[:, :, ih][:, :, :, iw]


class SDXLBrushNetPipeline:
    """SDXL + BrushNet over port params (see ``convert``): the UNet (with
    its DoRA adapters), the VAE, BrushNet and the two CLIP text encoders.
    ``device`` defaults to "cuda" and raises without a card unless "cpu"
    is asked for; params must already live there."""

    def __init__(self, unet_params: Any, unet_cfg: UNet2DConfig, vae_params: Any,
                 vae_cfg: AutoencoderKLConfig, brushnet_params: Any = None,
                 brushnet_cfg: Optional[UNet2DConfig] = None, te1_params: Any = None,
                 te1_cfg: Optional[CLIPTextConfig] = None, te2_params: Any = None,
                 te2_cfg: Optional[CLIPTextConfig] = None, dtype=torch.float32, device="cuda",
                 mesh: Any = None):
        if mesh is not None:
            raise NotImplementedError("data-parallel generation over a device mesh (ROADMAP "
                                      "Queue 1 items 7 and 9) is not ported yet")
        self.device = resolve_device(device)
        self.unet_params, self.unet_cfg = unet_params, unet_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.brushnet_params, self.brushnet_cfg = brushnet_params, brushnet_cfg
        self.te1_params, self.te1_cfg = te1_params, te1_cfg
        self.te2_params, self.te2_cfg = te2_params, te2_cfg
        self.dtype = dtype

    @torch.no_grad()
    def encode_ids(self, ids1, ids2):
        """Token ids of the two CLIP tokenizers, (B, 77) each -> (prompt
        embeddings (B, 77, 2048), pooled embeddings (B, 1280))."""
        ids1 = torch.as_tensor(ids1, device=self.device)
        ids2 = torch.as_tensor(ids2, device=self.device)
        return sdxl_encode_prompt(self.te1_params, self.te1_cfg, self.te2_params, self.te2_cfg,
                                  ids1, ids2)

    @torch.no_grad()
    def __call__(self, prompt: Optional[str] = None, negative_prompt: str = "", *,
                 prompt_embeds=None, pooled_embeds=None, negative_prompt_embeds=None,
                 negative_pooled_embeds=None, image=None, mask=None, height: int = 1024,
                 width: int = 1024, num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 brushnet_conditioning_scale: float = 0.7, control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0, seed: int = 0, scheduler: str = "dpm",
                 output_type: str = "np", torch_compat_noise: bool = False):
        """Stylize (with ``image`` and ``mask``) or generate.  ``image``: the
        masked init image, HWC floats in [0, 1] (or (B, 3, H, W) in [-1, 1]);
        ``mask``: HW(C) floats in [0, 1], 1 = the character to keep.
        ``output_type``: "latent" (the final latents), "np" (a list of
        (H, W, 3) uint8 arrays), or "np_pm1" (the decoded (B, 3, H, W) fp32
        image in [-1, 1])."""
        if prompt is not None or prompt_embeds is None:
            raise NotImplementedError("string prompts (the CLIP tokenizers; ROADMAP Queue 1 "
                                      "item 7) are not ported yet: pass prompt_embeds and "
                                      "pooled_embeds from encode_ids")
        if scheduler != "dpm":
            raise NotImplementedError(f"scheduler {scheduler!r} (the LCM rollout; ROADMAP "
                                      "Queue 1 item 7) is not ported yet")
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type {output_type!r}: one of {OUTPUT_TYPES}")
        do_cfg = guidance_scale > 1.0
        if do_cfg and negative_prompt_embeds is None:
            raise ValueError("guidance_scale > 1 needs negative_prompt_embeds and "
                             f"negative_pooled_embeds (the encoded {negative_prompt!r})")
        dev, dt = self.device, self.dtype

        def on_dev(t):
            return torch.as_tensor(t).to(dev, torch.float32)

        prompt_embeds, pooled_embeds = on_dev(prompt_embeds), on_dev(pooled_embeds)
        batch = prompt_embeds.shape[0]
        if do_cfg:
            negative_prompt_embeds = on_dev(negative_prompt_embeds)
            negative_pooled_embeds = on_dev(negative_pooled_embeds)
            if negative_prompt_embeds.shape[0] == 1 and batch > 1:
                negative_prompt_embeds = negative_prompt_embeds.expand(batch, -1, -1)
                negative_pooled_embeds = negative_pooled_embeds.expand(batch, -1)

        sched = DPMSolverMultistepScheduler()
        sched.set_timesteps(num_inference_steps)
        sf, f = self.vae_cfg.scaling_factor, self.vae_cfg.downscale_factor
        lat_shape = (1, self.vae_cfg.latent_channels, height // f, width // f)
        # DPM-Solver has init_noise_sigma 1: the noise is the first latents
        latents = torch.cat([generate_noise(lat_shape, seed=seed + i, dtype=torch.float32,
                                            torch_compat=torch_compat_noise, device=dev)
                             for i in range(batch)])

        use_brushnet = self.brushnet_params is not None and image is not None
        cond = None
        if use_brushnet:
            if isinstance(image, (list, tuple)):
                img = torch.cat([_to_nchw_pm1(i) for i in image])
                msk = torch.cat([_to_nchw_pm1(m) for m in mask])
            else:
                img, msk = _to_nchw_pm1(image), _to_nchw_pm1(mask)
            img, msk = img.to(dev), msk.to(dev)
            if img.shape[0] == 1 and batch > 1:
                img, msk = img.expand(batch, -1, -1, -1), msk.expand(batch, -1, -1, -1)
            # 1 = background to paint: the mask's channel sum below 0 in [-1, 1]
            original_mask = (msk.sum(1, keepdim=True) < 0).float()
            cond_lat = vae_encode(self.vae_params, self.vae_cfg, img.to(dt)).float() * sf
            m = _nearest_resize(original_mask, cond_lat.shape[-2], cond_lat.shape[-1])
            cond = torch.cat([cond_lat, m], 1)
            if do_cfg:
                cond = torch.cat([cond, cond])
            cond = cond.to(dt)

        # SDXL micro-conditioning: original size, crop (0, 0), target size
        add_time_ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                                    device=dev).expand(batch, -1)
        if do_cfg:
            ehs = torch.cat([negative_prompt_embeds, prompt_embeds])
            text_embeds = torch.cat([negative_pooled_embeds, pooled_embeds])
            time_ids = torch.cat([add_time_ids, add_time_ids])
        else:
            ehs, text_embeds, time_ids = prompt_embeds, pooled_embeds, add_time_ids
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
                    text_embeds=text_embeds, time_ids=time_ids,
                    conditioning_scale=brushnet_conditioning_scale * keep[i])
                kwargs = dict(down_block_add_samples=down, mid_block_add_sample=mid,
                              up_block_add_samples=up)
            noise_pred = unet2d_forward(self.unet_params, self.unet_cfg, x_in, t, ehs,
                                        text_embeds=text_embeds, time_ids=time_ids,
                                        **kwargs).float()
            if do_cfg:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
            latents, state = DPMSolverMultistepScheduler.step_from_tables(tables, state,
                                                                          noise_pred, i, latents)
        if output_type == "latent":
            return latents
        # fp32 decode
        image_out = vae_decode(cast_tree(self.vae_params, torch.float32), self.vae_cfg,
                               latents / sf)
        if output_type == "np_pm1":
            return image_out
        return [postprocess_image(f) for f in image_out.cpu().numpy()]
