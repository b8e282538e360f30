"""Rectified-flow (flow matching) scheduler, Wan, FLUX.1 and Z-Image
templates (port of fairygen_tpu/diffusion/flow_match.py).

The schedule is a host-side float64 numpy table; steps are indexed by the
integer step id.  Other templates (Qwen-Image, FLUX.2) are not on the
ported paths yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["FlowMatchScheduler"]


def _sigmas_shifted(num_steps, denoising_strength, shift, endpoint: bool):
    """linspace(σ_start, 0) (with or without the endpoint), then
    σ ← s·σ/(1+(s−1)σ)."""
    if endpoint:
        sigmas = np.linspace(denoising_strength, 0.0, num_steps, dtype=np.float64)
    else:
        sigmas = np.linspace(denoising_strength, 0.0, num_steps + 1, dtype=np.float64)[:-1]
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def set_timesteps_wan(num_inference_steps=100, denoising_strength=1.0, shift=None):
    shift = 5.0 if shift is None else shift
    sigmas = _sigmas_shifted(num_inference_steps, denoising_strength, shift, endpoint=False)
    return sigmas, sigmas * 1000.0


def set_timesteps_flux(num_inference_steps=100, denoising_strength=1.0, shift=None):
    """linspace(σ_start, σ_min) with the endpoint, σ_min = 0.003/1.002,
    then the rational shift (default 3)."""
    shift = 3.0 if shift is None else shift
    sigma_min = 0.003 / 1.002
    sigma_start = sigma_min + (1.0 - sigma_min) * denoising_strength
    sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps, dtype=np.float64)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return sigmas, sigmas * 1000.0


def set_timesteps_z_image(num_inference_steps=100, denoising_strength=1.0, shift=None,
                          target_timesteps=None):
    """Shift 3 without the endpoint; each of ``target_timesteps`` replaces
    the timestep nearest to it (the sigmas stay)."""
    shift = 3.0 if shift is None else shift
    sigmas = _sigmas_shifted(num_inference_steps, denoising_strength, shift, endpoint=False)
    timesteps = sigmas * 1000.0
    if target_timesteps is not None:
        for t in np.asarray(target_timesteps, dtype=np.float64):
            timesteps[int(np.argmin(np.abs(timesteps - t)))] = t
    return sigmas, timesteps


_TEMPLATES = {"Wan": set_timesteps_wan, "FLUX.1": set_timesteps_flux,
              "Z-Image": set_timesteps_z_image}


class FlowMatchScheduler:
    """Host-side schedule table + Euler step on tensors."""

    def __init__(self, template: str = "Wan"):
        if template not in _TEMPLATES:
            raise NotImplementedError(f"flow-match template {template!r} is not ported yet")
        self.set_timesteps_fn = _TEMPLATES[template]
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None
        self.training = False
        self.linear_timesteps_weights: Optional[np.ndarray] = None

    def set_timesteps(self, num_inference_steps=100, denoising_strength=1.0, training=False,
                      **template_kwargs):
        """``template_kwargs``: the template's own (``shift``; Z-Image also
        ``target_timesteps``)."""
        self.sigmas, self.timesteps = self.set_timesteps_fn(
            num_inference_steps, denoising_strength, **template_kwargs)
        self.training = training
        if training:
            self._set_training_weight()
        return self

    def _set_training_weight(self):
        """The training loss weights: a Gaussian bell over the timesteps,
        shifted to a zero minimum and normalised, in float32."""
        steps = 1000
        x = self.timesteps.astype(np.float32)
        y = np.exp(-2 * ((x - steps / 2) / steps) ** 2)
        y_shifted = y - y.min()
        w = y_shifted * (steps / y_shifted.sum())
        if len(self.timesteps) != 1000:
            w = w * (len(self.timesteps) / steps)
            w = w + w[1]
        self.linear_timesteps_weights = w

    def step(self, model_output, step_index: int, sample):
        """Euler flow step x += v·(σ_{i+1} − σ_i), σ_n = 0; the step size
        is rounded to the sample's dtype as in the JAX package."""
        sig = np.append(self.sigmas, 0.0).astype(np.float32)
        coef = torch.tensor(float(sig[step_index + 1] - sig[step_index]),
                            dtype=torch.float32).to(sample.dtype)
        return sample + model_output.to(sample.dtype) * coef.to(sample.device)

    def add_noise(self, original_samples, noise, step_index: int):
        """(1 − σ)·x₀ + σ·ε at step ``step_index``, σ rounded to the
        sample's dtype first as in the JAX package."""
        sigma = torch.tensor(float(np.float32(self.sigmas[step_index])), dtype=torch.float32,
                             device=original_samples.device).to(original_samples.dtype)
        return (1 - sigma) * original_samples + sigma * noise
