"""LCM (Latent Consistency Model) scheduler, the few-step SDXL sampler (port
of fairygen_tpu/diffusion/lcm.py).

SDXL's DDPM alphas (scaled-linear betas 0.00085 -> 0.012), origin-grid
timestep skipping, the boundary-condition scalings (sigma_data 0.5,
timestep_scaling 10) and fresh noise injected between multistep samples,
as diffusers v0.27 ``schedulers/scheduling_lcm.py``.  The schedule is
host-side float64 numpy; :meth:`LCMScheduler.tables` hands the per-step
constants to the device as float32, and :meth:`LCMScheduler.step_from_tables`
takes the injected noise explicitly (drawn by the caller from the seed), as
the JAX package's pure form does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["LCMScheduler"]


class LCMScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                 original_inference_steps: int = 50, prediction_type: str = "epsilon",
                 timestep_scaling: float = 10.0, sigma_data: float = 0.5,
                 set_alpha_to_one: bool = True):
        if beta_schedule != "scaled_linear":
            raise ValueError("only the scaled-linear beta schedule is ported")
        self.num_train_timesteps = num_train_timesteps
        self.original_inference_steps = original_inference_steps
        self.prediction_type = prediction_type
        self.timestep_scaling = timestep_scaling
        self.sigma_data = sigma_data
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = 1.0 if set_alpha_to_one else self.alphas_cumprod[0]
        self.timesteps: Optional[np.ndarray] = None
        self.num_inference_steps: Optional[int] = None

    def set_timesteps(self, num_inference_steps: int,
                      original_inference_steps: Optional[int] = None, strength: float = 1.0):
        """Origin-grid skipping (scheduling_lcm.py:396-486): the LCM was
        distilled on ``original_inference_steps`` evenly spaced training
        timesteps; inference picks ``num_inference_steps`` of those."""
        original_steps = original_inference_steps or self.original_inference_steps
        k = self.num_train_timesteps // original_steps
        lcm_origin = np.arange(1, int(original_steps * strength) + 1) * k - 1
        if num_inference_steps > len(lcm_origin):
            raise ValueError(f"num_inference_steps={num_inference_steps} exceeds the "
                             f"{len(lcm_origin)} origin timesteps")
        lcm_origin = lcm_origin[::-1].copy()
        idx = np.floor(np.linspace(0, len(lcm_origin), num=num_inference_steps,
                                   endpoint=False)).astype(np.int64)
        self.timesteps = lcm_origin[idx]
        self.num_inference_steps = num_inference_steps
        return self

    def tables(self, device="cpu"):
        """The per-step constants as float32 tensors on ``device``."""
        t = self.timesteps
        n = len(t)
        prev_t = np.concatenate([t[1:], t[-1:]])
        alpha = self.alphas_cumprod[t]
        alpha_prev = np.where(prev_t >= 0, self.alphas_cumprod[prev_t], self.final_alpha_cumprod)
        scaled = t.astype(np.float64) * self.timestep_scaling
        c_skip = self.sigma_data ** 2 / (scaled ** 2 + self.sigma_data ** 2)
        c_out = scaled / (scaled ** 2 + self.sigma_data ** 2) ** 0.5
        # noise is injected on every step but the last
        use_noise = (np.arange(n) != n - 1).astype(np.float64)

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return dict(timesteps=f32(t), sqrt_alpha=f32(np.sqrt(alpha)),
                    sqrt_beta=f32(np.sqrt(1.0 - alpha)), sqrt_alpha_prev=f32(np.sqrt(alpha_prev)),
                    sqrt_beta_prev=f32(np.sqrt(1.0 - alpha_prev)), c_skip=f32(c_skip),
                    c_out=f32(c_out), use_noise=f32(use_noise))

    def step_from_tables(self, tables, model_output, step_index: int, sample, noise):
        """One LCM update (scheduling_lcm.py:500-590) in float32.  ``noise``
        is fresh N(0, 1) for the step (unused on the last, by the
        ``use_noise`` gate).  Returns (prev_sample, denoised), each in
        ``sample``'s dtype."""
        i = step_index
        x = sample.float()
        m = model_output.float()
        if self.prediction_type == "epsilon":
            x0 = (x - tables["sqrt_beta"][i] * m) / tables["sqrt_alpha"][i]
        elif self.prediction_type == "v_prediction":
            x0 = tables["sqrt_alpha"][i] * x - tables["sqrt_beta"][i] * m
        else:  # sample
            x0 = m
        denoised = tables["c_out"][i] * x0 + tables["c_skip"][i] * x
        prev = torch.where(tables["use_noise"][i] > 0,
                           tables["sqrt_alpha_prev"][i] * denoised
                           + tables["sqrt_beta_prev"][i] * noise.float(),
                           denoised)
        return prev.to(sample.dtype), denoised.to(sample.dtype)
