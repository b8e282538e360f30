"""Wan text+image-to-video pipeline, TI2V path (port of
fairygen_tpu/pipelines/wan_video.py ``WanVideoPipeline``).

The call: noise (``core.noise``), VAE38 encode of the first frame pinned
into latent frame 0, flow-match Euler steps with two batch-1 DiT sweeps for
CFG and a re-pin of frame 0 after each step, VAE38 decode.  The per-prompt
cross-attention (k, v) are computed once per call.  Prompts arrive as
encoded ``context`` / ``negative_context`` (:func:`encode_ids` runs UMT5 on
token ids); the tokenizer needs files the repository does not hold.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.imaging import check_resize_height_width, postprocess_video, preprocess_image
from ..core.noise import generate_noise
from ..device import resolve_device
from ..diffusion.flow_match import FlowMatchScheduler
from ..models.wan.dit import WanDiTConfig, precompute_cross_kv, wan_dit_forward
from ..models.wan.text_encoder import UMT5Config, mask_pad_tokens, umt5_encode
from ..models.wan.vae import WanVAEConfig, vae38_decode, vae38_encode


def _as_pil(image, width, height):
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    return image.resize((width, height))


class WanVideoPipeline:
    """Wan2.2-TI2V-5B pipeline over port params (see ``convert``).

    ``device`` defaults to "cuda" and raises without a card unless "cpu" is
    asked for; params must already live on that device."""

    def __init__(self, dit_params: Any, dit_cfg: WanDiTConfig, vae_params: Any = None,
                 vae_cfg: Optional[WanVAEConfig] = None, te_params: Any = None,
                 te_cfg: Optional[UMT5Config] = None, dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.dit_params, self.dit_cfg = dit_params, dit_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.te_params, self.te_cfg = te_params, te_cfg
        self.dtype = dtype

    @torch.no_grad()
    def encode_ids(self, ids, mask) -> torch.Tensor:
        """UMT5 on token ids (B, L) -> context zeroed past each length."""
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        emb = umt5_encode(self.te_params, self.te_cfg, ids, mask)
        return mask_pad_tokens(emb, mask).to(self.dtype)

    def _latent_shape(self, height, width, num_frames):
        f = self.vae_cfg.upsampling_factor
        return (1, self.vae_cfg.z_dim, (num_frames - 1) // 4 + 1, height // f, width // f)

    @torch.no_grad()
    def encode_first_frame(self, input_image):
        """TI2V first-frame latent (1, z, 1, h, w) of a PIL image."""
        img = torch.from_numpy(preprocess_image(input_image)[None, :, None])
        return vae38_encode(self.vae_params, self.vae_cfg,
                            img.to(self.device, self.dtype)).to(self.dtype)

    @torch.no_grad()
    def __call__(self, *, context, negative_context=None, input_image=None, seed: int = 0,
                 height: int = 480, width: int = 832, num_frames: int = 81,
                 cfg_scale: float = 5.0, num_inference_steps: int = 50,
                 sigma_shift: float = 5.0, output_type: str = "quantized",
                 torch_compat_noise: bool = False):
        f = self.vae_cfg.upsampling_factor
        height, width, num_frames = check_resize_height_width(
            height, width, num_frames, height_division_factor=f * 2,
            width_division_factor=f * 2, time_division_factor=4, time_division_remainder=1)
        context = context.to(self.device, self.dtype)
        use_cfg = cfg_scale != 1.0 and negative_context is not None
        if cfg_scale != 1.0 and negative_context is None:
            raise ValueError("cfg_scale != 1 needs negative_context (the encoded empty prompt)")

        latents = generate_noise(self._latent_shape(height, width, num_frames), seed=seed,
                                 dtype=self.dtype, torch_compat=torch_compat_noise,
                                 device=self.device)
        first = None
        if input_image is not None:
            if not self.dit_cfg.fuse_vae_embedding_in_latents:
                raise NotImplementedError("only the TI2V first-frame conditioning is ported")
            first = self.encode_first_frame(_as_pil(input_image, width, height))
            latents[:, :, 0:1] = first

        scheduler = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps,
                                                            shift=sigma_shift)
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)
        ckv_p = precompute_cross_kv(self.dit_params, self.dit_cfg, context)
        ckv_n = None
        if use_cfg:
            ckv_n = precompute_cross_kv(self.dit_params, self.dit_cfg,
                                        negative_context.to(self.device, self.dtype))
        fuse = first is not None
        for i in range(len(scheduler.timesteps)):
            t1 = timesteps[i:i + 1].to(self.device)
            v = wan_dit_forward(self.dit_params, self.dit_cfg, latents, t1,
                                fuse_vae_embedding_in_latents=fuse, cross_kv=ckv_p)
            if use_cfg:
                v_n = wan_dit_forward(self.dit_params, self.dit_cfg, latents, t1,
                                      fuse_vae_embedding_in_latents=fuse, cross_kv=ckv_n)
                # the guidance combine runs in fp32, as in the JAX package
                v = v_n.float() + cfg_scale * (v - v_n).float()
            latents = scheduler.step(v, i, latents)
            if fuse:
                latents[:, :, 0:1] = first
        return self._decode_output(latents, output_type)

    def _decode_output(self, latents, output_type):
        if self.vae_params is None or output_type == "latents":
            return latents
        video = vae38_decode(self.vae_params, self.vae_cfg, latents.to(self.dtype))
        if output_type == "floatpoint":
            return video
        return postprocess_video(video.float().cpu().numpy())
