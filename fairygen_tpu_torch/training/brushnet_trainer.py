"""BrushNet training, the masked-inpainting dual-branch finetune (port of
fairygen_tpu/training/brushnet_trainer.py ``random_brush_gen``,
``random_mask_gen``, ``rle2mask`` and ``make_brushnet_train_step``).

Upstream's ``stylization/BrushNet/examples/brushnet/train_brushnet_sdxl.py``:
random brush-stroke / RLE segmentation masks (:863-911), the masked-image
conditioning latents (VAE(masked) x scaling factor beside the mask, five
channels at the latent grid, :921-956), ε-prediction MSE on DDPM-noised
latents, and only the BrushNet branch trains while the SDXL UNet stays
frozen.  The mask generators are numpy + PIL and give the JAX package's
masks bit for bit from the same ``RandomState``.  In the bf16 UNet on the
card the gradient crosses every transformer block of the UNet (BrushNet's
residuals enter after conv_in) and BrushNet's mid attention: each runs
K6a, K6b and K6c in bf16 at head dim 64 (``ops/flash_attention.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.ddpm import DDPMScheduler
from ..models.adapters import leaves_with_path
from ..models.sdxl.unet2d import UNet2DConfig, brushnet_forward, unet2d_forward
from .train_step import _trainer


# ----------------------------------------------------------- mask generation
def random_brush_gen(rng: np.random.RandomState, max_tries, h, w, min_num_vertex=4,
                     max_num_vertex=18, mean_angle=2 * math.pi / 5,
                     angle_range=2 * math.pi / 15, min_width=12, max_width=48) -> np.ndarray:
    """Random brush strokes (train_brushnet_sdxl.py's random_brush path):
    polyline walks of varying width, rasterised with PIL; (h, w) uint8."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for _ in range(rng.randint(1, max_tries + 1)):
        num_vertex = rng.randint(min_num_vertex, max_num_vertex + 1)
        angle_min = mean_angle - rng.uniform(0, angle_range)
        angle_max = mean_angle + rng.uniform(0, angle_range)
        angles = []
        for i in range(num_vertex):
            a = rng.uniform(angle_min, angle_max)
            angles.append(2 * math.pi - a if i % 2 == 0 else a)
        vx, vy = rng.randint(0, w), rng.randint(0, h)
        vertex = [(vx, vy)]
        avg_radius = math.hypot(h, w) / 8
        for a in angles:
            r = np.clip(rng.normal(avg_radius, avg_radius // 2), 0, 2 * avg_radius)
            nx = np.clip(vertex[-1][0] + r * math.cos(a), 0, w)
            ny = np.clip(vertex[-1][1] + r * math.sin(a), 0, h)
            vertex.append((int(nx), int(ny)))
        width = int(rng.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for vx, vy in vertex:
            draw.ellipse((vx - width // 2, vy - width // 2, vx + width // 2, vy + width // 2),
                         fill=1)
    return np.asarray(mask, np.uint8)


def random_mask_gen(rng: np.random.RandomState, h, w) -> np.ndarray:
    """The reserved = 1 / hole = 0 mask (train_brushnet_sdxl.py:863-866),
    (h, w) float32."""
    mask = np.ones((h, w), np.uint8)
    mask = np.logical_and(mask, 1 - random_brush_gen(rng, 4, h, w))
    return mask.astype(np.float32)


def rle2mask(mask_rle, shape) -> np.ndarray:
    """RLE segmentation decode (train_brushnet_sdxl.py:869-878): 1-based
    (start, length) pairs over the column-major image."""
    mask_rle = np.array(mask_rle)
    starts, lengths = mask_rle[0:][::2].astype(int), mask_rle[1:][::2].astype(int)
    starts -= 1
    img = np.zeros(shape[0] * shape[1], np.uint8)
    for lo, hi in zip(starts, starts + lengths):
        img[lo:hi] = 1
    return img.reshape(shape, order="F")


# ------------------------------------------------------------------ training
def make_brushnet_train_step(unet_cfg: UNet2DConfig, brushnet_cfg: UNet2DConfig,
                             unet_params: Any, optimizer, *,
                             scheduler: Optional[DDPMScheduler] = None,
                             conditioning_scale: float = 1.0, device="cuda"):
    """(init_state, train_step) training the BrushNet branch only.

    ``init_state(brushnet_params)``; ``train_step(state, batch, generator,
    *, timesteps=None, noise=None) -> (state, loss)``.  The batch holds
    ``latents`` (B, 4, h, w), scaled; ``cond_latents`` (B, 4, h, w),
    VAE(masked image) x scaling factor; ``mask_latents`` (B, 1, h, w);
    ``prompt_embeds``, ``pooled`` and ``time_ids`` (B, 6).  The generator
    draws, in order, the timesteps (uniform integers below
    ``num_train_timesteps``) and the noise, as the JAX loss draws them from
    its two keys; ``timesteps`` / ``noise`` replace the two draws.  Every
    floating tensor of the BrushNet tree trains; the UNet's are frozen
    (``requires_grad`` off) and stay as they are, bit for bit.
    ``train_step.loss_and_grads(state, batch, generator, ...)`` gives the
    loss and the gradients (path -> tensor) without an update."""
    resolve_device(device)
    sched = scheduler or DDPMScheduler()
    for _, leaf in leaves_with_path(unet_params):
        if isinstance(leaf, torch.Tensor):
            leaf.requires_grad_(False)

    def loss_fn(bn_params, batch, generator, timesteps=None, noise=None):
        latents = batch["latents"]
        b, dev = latents.shape[0], latents.device
        if timesteps is None:
            timesteps = torch.randint(0, sched.num_train_timesteps, (b,), generator=generator,
                                      device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev,
                                dtype=latents.dtype)
        timesteps = torch.as_tensor(timesteps, device=dev).long()
        noise = torch.as_tensor(noise).to(dev, latents.dtype)
        noisy = sched.add_noise(latents, noise, timesteps)
        cond = torch.cat([batch["cond_latents"], batch["mask_latents"]], 1)
        down, mid, up = brushnet_forward(bn_params, brushnet_cfg, noisy, timesteps.float(),
                                         batch["prompt_embeds"], cond,
                                         text_embeds=batch["pooled"], time_ids=batch["time_ids"],
                                         conditioning_scale=conditioning_scale)
        pred = unet2d_forward(unet_params, unet_cfg, noisy, timesteps.float(),
                              batch["prompt_embeds"], text_embeds=batch["pooled"],
                              time_ids=batch["time_ids"], down_block_add_samples=down,
                              mid_block_add_sample=mid, up_block_add_samples=up)
        return ((pred.float() - noise.float()) ** 2).mean()

    return _trainer(loss_fn, optimizer, None)
