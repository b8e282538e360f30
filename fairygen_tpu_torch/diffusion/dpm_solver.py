"""DPM-Solver++ multistep scheduler, order 2: the BrushNet-SDXL sampler (port
of fairygen_tpu/diffusion/dpm_solver.py).

The SDXL DDPM config: scaled-linear betas, ``algorithm_type="dpmsolver++"``,
``solver_order=2``, ``lower_order_final=True``, leading timestep spacing
with offset 1.  The schedule and the per-step update coefficients are
host-side float64 numpy tables; :meth:`DPMSolverMultistepScheduler.tables`
hands them to the device as float32, and a step is

    x_next = c_x[i]·x + c0[i]·x0 + c1[i]·(x0 − prev_x0)

in float32, with the previous x0 carried in an explicit :class:`DPMState`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["DPMState", "DPMSolverMultistepScheduler"]


@dataclasses.dataclass
class DPMState:
    prev_x0: torch.Tensor  # the model output converted to x0 at step i-1
    has_prev: bool = False  # whether prev_x0 is valid


class DPMSolverMultistepScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                 prediction_type: str = "epsilon", timestep_spacing: str = "leading",
                 steps_offset: int = 1, solver_order: int = 2, lower_order_final: bool = True):
        if beta_schedule != "scaled_linear" or solver_order != 2:
            raise ValueError("only the scaled-linear, order-2 solver is ported")
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        self.lower_order_final = lower_order_final
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.num_inference_steps: Optional[int] = None

    def set_timesteps(self, num_inference_steps: int):
        n, N = num_inference_steps, self.num_train_timesteps
        if self.timestep_spacing == "leading":
            step = N // (n + 1)
            ts = (np.arange(n + 1) * step).round()[::-1][:-1].astype(np.int64)
            ts += self.steps_offset
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, N - 1, n + 1).round()[::-1][:-1].astype(np.int64)
        else:
            raise ValueError(self.timestep_spacing)
        self.num_inference_steps = n
        self.timesteps = ts
        ac = self.alphas_cumprod[ts]
        # sigma space (σ = sqrt(1-ᾱ)/sqrt(ᾱ)), final σ = 0; the data-space
        # α̂ = 1/sqrt(1+σ²), σ̂ = σ·α̂ over the extended grid
        self.sigmas = np.concatenate([np.sqrt(1 - ac) / np.sqrt(ac), [0.0]])
        self._alpha_hat = 1.0 / np.sqrt(self.sigmas ** 2 + 1)
        self._sigma_hat = self.sigmas * self._alpha_hat
        self._build_step_tables()
        return self

    def _build_step_tables(self):
        """c_x, c0, c1 per step (c1 = 0 on the first-order steps: the first,
        the last with ``lower_order_final``, and any step to σ = 0)."""
        n = self.num_inference_steps
        sig, ah, sh = self.sigmas, self._alpha_hat, self._sigma_hat

        def lam(j):
            return np.log(ah[j]) - np.log(sh[j]) if sig[j] > 0 else np.inf

        c_x, c0, c1 = (np.zeros((n,), np.float64) for _ in range(3))
        for i in range(n):
            s, t = i, i + 1
            if sig[t] == 0:
                c_x[i], c0[i], c1[i] = 0.0, 1.0, 0.0
                continue
            first = (i == 0) or (self.lower_order_final and i == n - 1)
            h = lam(t) - lam(s)
            e = np.exp(-h) - 1.0
            c_x[i] = sh[t] / sh[s]
            c0[i] = -ah[t] * e
            if not first and np.isfinite(h):
                r = (lam(s) - lam(i - 1)) / h
                c1[i] = -0.5 * ah[t] * e / r
        self._c_x, self._c0, self._c1 = c_x, c0, c1

    def init_state(self, shape, dtype=torch.float32, device="cpu") -> DPMState:
        return DPMState(prev_x0=torch.zeros(shape, dtype=dtype, device=device), has_prev=False)

    def tables(self, device="cpu"):
        """The step tables as float32 tensors on ``device``."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return dict(timesteps=f32(self.timesteps), alpha_hat=f32(self._alpha_hat[:-1]),
                    sigma_hat=f32(self._sigma_hat[:-1]), c_x=f32(self._c_x), c0=f32(self._c0),
                    c1=f32(self._c1))

    @staticmethod
    def step_from_tables(tables, state: DPMState, model_output, step_index: int, sample,
                         prediction_type: str = "epsilon"):
        """One DPM-Solver++(2M) step over a :meth:`tables` dict, in float32;
        returns (x_next, new state)."""
        i = step_index
        x = sample.float()
        m = model_output.float()
        if prediction_type == "epsilon":
            x0 = (x - tables["sigma_hat"][i] * m) / tables["alpha_hat"][i]
        elif prediction_type == "v_prediction":
            x0 = tables["alpha_hat"][i] * x - tables["sigma_hat"][i] * m
        elif prediction_type == "sample":
            x0 = m
        else:
            raise ValueError(prediction_type)
        d1 = x0 - state.prev_x0 if state.has_prev else torch.zeros_like(x0)
        x_next = tables["c_x"][i] * x + tables["c0"][i] * x0 + tables["c1"][i] * d1
        return x_next.to(sample.dtype), DPMState(prev_x0=x0, has_prev=True)
