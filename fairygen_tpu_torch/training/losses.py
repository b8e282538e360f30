"""Training loss (port of fairygen_tpu/training/losses.py
``flow_match_sft_loss``): a uniform random timestep index within the
[min, max] boundary fractions, rectified-flow noising, and the weighted MSE
on the (noise − x₀) velocity target.

The draws are kept apart from the arithmetic: the timestep index and the
noise come from ``generator``, or are given as ``index`` / ``noise`` (the
CPU tests hand the port the JAX package's own draws).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def draw_index(generator, n: int, min_timestep_boundary: float = 0.0,
               max_timestep_boundary: float = 1.0) -> int:
    """A uniform timestep index in [min·n, max·n)."""
    lo, hi = int(min_timestep_boundary * n), int(max_timestep_boundary * n)
    return int(torch.randint(lo, hi, (1,), generator=generator, device=generator.device))


def flow_match_sft_loss(
    model_fn: Callable,  # (params, noisy_latents, timestep, context) -> v_pred
    params,
    input_latents,  # (B, C, F, H, W) clean latents
    context,  # (B, L, text_dim)
    generator=None,
    *,
    sigmas: np.ndarray,
    timesteps: np.ndarray,
    weights: np.ndarray,
    min_timestep_boundary: float = 0.0,
    max_timestep_boundary: float = 1.0,
    first_frame_clean: bool = False,
    index: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
):
    if index is None:
        index = draw_index(generator, len(timesteps), min_timestep_boundary,
                           max_timestep_boundary)
    if noise is None:
        noise = torch.randn(input_latents.shape, generator=generator,
                            device=input_latents.device).to(input_latents.dtype)
    dev, dt = input_latents.device, input_latents.dtype
    sig = torch.tensor(float(np.float32(sigmas[index])), device=dev).to(dt)
    noisy = (1 - sig) * input_latents + sig * noise
    if first_frame_clean:
        # TI2V first-frame conditioning: the first latent frame stays clean
        noisy = torch.cat([input_latents[:, :, :1], noisy[:, :, 1:]], dim=2)
    target = noise - input_latents
    timestep = torch.full((input_latents.shape[0],), float(np.float32(timesteps[index])),
                          dtype=torch.float32, device=dev)
    pred = model_fn(params, noisy, timestep, context)
    loss = torch.mean((pred.float() - target.float()) ** 2)
    return loss * float(np.float32(weights[index]))
