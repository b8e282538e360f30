"""Z-Image (Turbo) text-to-image pipeline (port of
fairygen_tpu/pipelines/z_image.py ``ZImagePipeline``).

The call: seeded noise (or given ``latents``), the "Z-Image" flow-match
schedule, one DiT sweep per step (two with true CFG, ``cfg_scale`` != 1)
with the model's timestep inversion (1000 - t)/1000 and output negation,
an optional image-to-image start (FLUX VAE encode, then ``add_noise``), and
the fp32 decode of the (shift, scale)-normalized latents by the FLUX.1
16-channel VAE.  Prompts arrive as Qwen3 hidden states;
:meth:`ZImagePipeline.encode_ids` runs the encoder on token ids, in place
of the JAX package's tokenizer and chat template, which need files the
repository does not hold.  ``from_pretrained``, ``quantize`` and string
prompts are not ported and raise.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.imaging import postprocess_image, preprocess_image
from ..core.noise import generate_noise
from ..core.params import cast_tree
from ..device import resolve_device
from ..diffusion.flow_match import FlowMatchScheduler
from ..models.qwen.text_encoder import QwenVLTextConfig, qwen_vl_text_encode
from ..models.sdxl.vae import AutoencoderKLConfig, vae_decode, vae_encode
from ..models.z_image.dit import ZImageDiTConfig, z_image_dit_forward

OUTPUT_TYPES = ("latent", "np", "pil", "floatpoint")


class ZImagePipeline:
    """Z-Image over port params (see ``convert``): the DiT, the FLUX VAE and
    the Qwen3 text encoder.  ``device`` defaults to "cuda" and raises
    without a card unless "cpu" is asked for; params must already live
    there."""

    def __init__(self, dit_params: Any, dit_cfg: ZImageDiTConfig, vae_params: Any = None,
                 vae_cfg: Optional[AutoencoderKLConfig] = None, te_params: Any = None,
                 te_cfg: Optional[QwenVLTextConfig] = None, dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dit_params, self.dit_cfg = dit_params, dit_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.te_params, self.te_cfg = te_params, te_cfg
        self.dtype = dtype

    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        raise NotImplementedError("ZImagePipeline.from_pretrained (the model pool, checkpoint "
                                  "loading and the tokenizer; ROADMAP Queue 1 item 8) is not "
                                  "ported yet")

    def quantize(self):
        raise NotImplementedError("W8A8 quantize (ops/quant.py; ROADMAP Queue 1 item 4) is not "
                                  "ported yet")

    @torch.no_grad()
    def encode_ids(self, ids, attention_mask=None):
        """Token ids (B, L) -> the Qwen3 penultimate hidden states (B, L,
        dim) in the pipeline's dtype (Z-Image's prompt embedding)."""
        ids = torch.as_tensor(ids, device=self.device)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=self.device)
        hidden = qwen_vl_text_encode(self.te_params, self.te_cfg, ids,
                                     attention_mask=attention_mask, hidden_state_index=-2)
        return hidden.to(self.dtype)

    def _encode_image(self, image):
        arr = torch.from_numpy(preprocess_image(image)[None]).to(self.device)
        mean = vae_encode(self.vae_params, self.vae_cfg, arr)
        z = (mean - self.vae_cfg.shift_factor) * self.vae_cfg.scaling_factor
        return z.to(self.dtype)

    def _sweep(self, x, t, emb):
        # the model's timestep inversion and output negation
        tt = (1000.0 - t) / 1000.0
        return -z_image_dit_forward(self.dit_params, self.dit_cfg, x, tt, emb)

    @torch.no_grad()
    def __call__(self, prompt: Optional[str] = None, negative_prompt: str = "",
                 cfg_scale: float = 1.0, input_image=None, denoising_strength: float = 1.0,
                 height: int = 1024, width: int = 1024, seed: Optional[int] = None,
                 num_inference_steps: int = 8, prompt_emb=None, negative_prompt_emb=None,
                 latents=None, output_type: str = "np"):
        """Text (or image) to image.  ``prompt_emb`` (1, L, dim) from
        :meth:`encode_ids`; ``input_image`` an (H, W, 3) uint8 image for
        image-to-image at ``denoising_strength``.  ``output_type``: "latent"
        (the final latents), "np" (an (H, W, 3) uint8 array), "pil", or
        "floatpoint" (the decoded (1, 3, H, W) fp32 image in [-1, 1])."""
        if prompt is not None or prompt_emb is None:
            raise NotImplementedError("string prompts (the Qwen3 tokenizer and chat template; "
                                      "ROADMAP Queue 1 item 8) are not ported yet: pass "
                                      "prompt_emb from encode_ids")
        if height % 16 or width % 16:
            raise ValueError(f"height and width must be multiples of 16, got {height}x{width}")
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type {output_type!r}: one of {OUTPUT_TYPES}")
        do_cfg = cfg_scale != 1.0
        if do_cfg and negative_prompt_emb is None:
            raise ValueError("cfg_scale != 1 needs negative_prompt_emb (the encoded negative "
                             f"prompt {negative_prompt!r})")
        sched = FlowMatchScheduler("Z-Image").set_timesteps(
            num_inference_steps, denoising_strength=denoising_strength)
        dev, dt = self.device, self.dtype
        timesteps = torch.tensor(sched.timesteps, dtype=torch.float32, device=dev)
        prompt_emb = torch.as_tensor(prompt_emb).to(dev, dt)
        if do_cfg:
            negative_prompt_emb = torch.as_tensor(negative_prompt_emb).to(dev, dt)

        zc = self.vae_cfg.latent_channels if self.vae_cfg else self.dit_cfg.in_channels
        if latents is not None:
            noise = torch.as_tensor(latents).to(dev, dt)
        else:
            noise = generate_noise((1, zc, height // 8, width // 8),
                                   seed=0 if seed is None else seed, dtype=dt, device=dev)
        if input_image is not None:
            x = sched.add_noise(self._encode_image(input_image), noise, 0).to(dt)
        else:
            x = noise

        scale = torch.tensor(cfg_scale, dtype=torch.float32, device=dev)
        for i in range(len(sched.timesteps)):
            t = timesteps[i].expand(x.shape[0])
            v = self._sweep(x, t, prompt_emb)
            if do_cfg:
                v_n = self._sweep(x, t, negative_prompt_emb)
                v = v_n + scale.to(v.dtype) * (v - v_n)
            x = sched.step(v, i, x)
        if output_type == "latent":
            return x
        # fp32 decode of the (shift, scale)-normalized latents
        z = x.float() / self.vae_cfg.scaling_factor + self.vae_cfg.shift_factor
        image = vae_decode(cast_tree(self.vae_params, torch.float32), self.vae_cfg, z)
        if output_type == "floatpoint":
            return image
        arr = postprocess_image(image[0].cpu().numpy())
        if output_type == "pil":
            from PIL import Image

            return Image.fromarray(arr)
        return arr
