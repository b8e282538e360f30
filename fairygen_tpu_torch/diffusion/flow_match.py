"""Rectified-flow (flow matching) scheduler, Wan template (port of
fairygen_tpu/diffusion/flow_match.py).

The schedule is a host-side float64 numpy table; steps are indexed by the
integer step id.  Other templates (FLUX, Qwen-Image, Z-Image) are not on
the ported path yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["FlowMatchScheduler"]


def _sigmas_shifted(num_steps, denoising_strength, shift):
    """linspace(σ_start, 0) without the endpoint, then σ ← s·σ/(1+(s−1)σ)."""
    sigmas = np.linspace(denoising_strength, 0.0, num_steps + 1, dtype=np.float64)[:-1]
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def set_timesteps_wan(num_inference_steps=100, denoising_strength=1.0, shift=None):
    shift = 5.0 if shift is None else shift
    sigmas = _sigmas_shifted(num_inference_steps, denoising_strength, shift)
    return sigmas, sigmas * 1000.0


class FlowMatchScheduler:
    """Host-side schedule table + Euler step on tensors."""

    def __init__(self, template: str = "Wan"):
        if template != "Wan":
            raise NotImplementedError(f"flow-match template {template!r} is not ported yet")
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None

    def set_timesteps(self, num_inference_steps=100, denoising_strength=1.0, shift=None):
        self.sigmas, self.timesteps = set_timesteps_wan(
            num_inference_steps, denoising_strength, shift)
        return self

    def step(self, model_output, step_index: int, sample):
        """Euler flow step x += v·(σ_{i+1} − σ_i), σ_n = 0; the step size
        is rounded to the sample's dtype as in the JAX package."""
        sig = np.append(self.sigmas, 0.0).astype(np.float32)
        coef = torch.tensor(float(sig[step_index + 1] - sig[step_index]),
                            dtype=torch.float32).to(sample.dtype)
        return sample + model_output.to(sample.dtype) * coef.to(sample.device)
