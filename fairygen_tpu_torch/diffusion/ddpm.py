"""DDPM (ε-prediction) scheduler of the SDXL stylization path (port of
fairygen_tpu/diffusion/ddpm.py ``DDPMScheduler``).

What FairyGen uses of diffusers' DDPMScheduler: the beta schedules
("scaled_linear", "linear", "squaredcos_cap_v2"), ``alphas_cumprod``,
``set_timesteps`` ("leading" with ``steps_offset``, "linspace",
"trailing"), ``add_noise``, ``get_velocity``, ``snr`` and the ancestral
``step`` (fixed_small variance).  The tables are host-side numpy, as in the
JAX package; ``add_noise``, ``get_velocity``, ``snr`` and ``step`` take
tensors and gather the fp32 table on their device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["DDPMScheduler"]


class DDPMScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                 prediction_type: str = "epsilon", timestep_spacing: str = "leading",
                 steps_offset: int = 1, clip_sample: bool = False,
                 variance_type: str = "fixed_small"):
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        self.clip_sample = clip_sample
        self.variance_type = variance_type

        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                                dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "squaredcos_cap_v2":
            t = np.arange(num_train_timesteps, dtype=np.float64)

            def bar(u):
                return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.minimum(1 - bar((t + 1) / num_train_timesteps)
                               / bar(t / num_train_timesteps), 0.999)
        else:
            raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas)
        self.timesteps = np.arange(num_train_timesteps)[::-1].copy()
        self.num_inference_steps: Optional[int] = None

    # ------------------------------------------------------------- schedules
    def set_timesteps(self, num_inference_steps: int):
        n, N = num_inference_steps, self.num_train_timesteps
        if self.timestep_spacing == "leading":
            ts = (np.arange(n) * (N // n)).round()[::-1].astype(np.int64) + self.steps_offset
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, N - 1, n).round()[::-1].astype(np.int64)
        elif self.timestep_spacing == "trailing":
            ts = np.arange(N, 0, -N / n).round().astype(np.int64) - 1
        else:
            raise ValueError(f"unknown timestep_spacing {self.timestep_spacing!r}")
        self.num_inference_steps = n
        self.timesteps = ts
        return self

    # ---------------------------------------------------------- tensor ops
    def _ac(self, timesteps, device):
        """alphas_cumprod at ``timesteps`` (fp32, on ``device``)."""
        table = torch.as_tensor(self.alphas_cumprod, dtype=torch.float32, device=device)
        return table[torch.as_tensor(timesteps, device=device).long()]

    def add_noise(self, original_samples, noise, timesteps):
        ac = self._ac(timesteps, original_samples.device)
        shape = (-1,) + (1,) * (original_samples.dim() - 1)
        sqrt_ac = torch.sqrt(ac).to(original_samples.dtype).reshape(shape)
        sqrt_1mac = torch.sqrt(1.0 - ac).to(original_samples.dtype).reshape(shape)
        return sqrt_ac * original_samples + sqrt_1mac * noise

    def get_velocity(self, sample, noise, timesteps):
        ac = self._ac(timesteps, sample.device)
        shape = (-1,) + (1,) * (sample.dim() - 1)
        sqrt_ac = torch.sqrt(ac).reshape(shape).to(sample.dtype)
        sqrt_1mac = torch.sqrt(1.0 - ac).reshape(shape).to(sample.dtype)
        return sqrt_ac * noise - sqrt_1mac * sample

    def snr(self, timesteps, device=None):
        ac = self._ac(timesteps, device)
        return ac / (1.0 - ac)

    def _predict_x0(self, model_output, sample, ac_t):
        if self.prediction_type == "epsilon":
            return (sample - torch.sqrt(1 - ac_t) * model_output) / torch.sqrt(ac_t)
        if self.prediction_type == "v_prediction":
            return torch.sqrt(ac_t) * sample - torch.sqrt(1 - ac_t) * model_output
        if self.prediction_type == "sample":
            return model_output
        raise ValueError(f"unknown prediction_type {self.prediction_type!r}")

    def step(self, model_output, timestep, sample, noise=None):
        """One ancestral DDPM step (fixed_small variance), in fp32, returned
        in ``sample``'s dtype."""
        t = int(timestep)
        step_ratio = (self.num_train_timesteps // self.num_inference_steps
                      if self.num_inference_steps else 1)
        prev_t = t - step_ratio
        ac = self.alphas_cumprod
        dev = sample.device

        def f32(x):
            return torch.tensor(np.float32(x), device=dev)

        ac_t = f32(ac[t])
        ac_prev = f32(ac[prev_t]) if prev_t >= 0 else f32(1.0)
        beta_t = 1 - ac_t / ac_prev
        alpha_t = 1 - beta_t
        x0 = self._predict_x0(model_output.float(), sample.float(), ac_t)
        if self.clip_sample:
            x0 = x0.clamp(-1, 1)
        x0_coef = torch.sqrt(ac_prev) * beta_t / (1 - ac_t)
        xt_coef = torch.sqrt(alpha_t) * (1 - ac_prev) / (1 - ac_t)
        mean = x0_coef * x0 + xt_coef * sample.float()
        if prev_t >= 0 and noise is not None:
            var = ((1 - ac_prev) / (1 - ac_t) * beta_t).clamp_min(1e-20)
            mean = mean + torch.sqrt(var) * noise.float()
        return mean.to(sample.dtype)
