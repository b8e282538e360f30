"""UniPC multistep scheduler, the SD1.5-BrushNet sampler (port of
fairygen_tpu/diffusion/unipc.py).

The reference SD1.5 entry point (BrushNet's ``examples/brushnet/
test_brushnet.py``) wraps the DDPM config in ``UniPCMultistepScheduler``:
scaled-linear betas, ``solver_order=2``, ``solver_type="bh2"``,
``predict_x0=True``, ``lower_order_final=True``.  At step i the UniC
corrector redoes the previous interval with the fresh model output, then the
UniP predictor takes the next one.  Every per-step coefficient is a
host-side float64 numpy table; :meth:`UniPCMultistepScheduler.tables` hands
them to the device as float32, and a step is

    x_corr = cc_x[i]·x_last + cc0[i]·m1 + cc1[i]·(m2 − m1) + cc2[i]·(x0 − m1)
    x_next = cp_x[i]·x_corr + cp0[i]·x0 + cp1[i]·(m1 − x0)

in float32 (x_corr = x at i = 0), with the two previous x0 predictions and
the previous sample carried in an explicit :class:`UniPCState`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["UniPCState", "UniPCMultistepScheduler"]


@dataclasses.dataclass
class UniPCState:
    m_prev: torch.Tensor  # the x0 prediction at step i-1
    m_prev2: torch.Tensor  # the x0 prediction at step i-2
    last_sample: torch.Tensor  # the sample before the predictor at step i-1


class UniPCMultistepScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                 prediction_type: str = "epsilon", timestep_spacing: str = "linspace",
                 steps_offset: int = 0, solver_order: int = 2, lower_order_final: bool = True):
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
        if self.timestep_spacing == "linspace":
            ts = np.linspace(0, N - 1, n + 1).round()[::-1][:-1].astype(np.int64)
        elif self.timestep_spacing == "leading":
            step = N // (n + 1)
            ts = (np.arange(n + 1) * step).round()[::-1][:-1].astype(np.int64)
            ts += self.steps_offset
        else:
            raise ValueError(self.timestep_spacing)
        self.num_inference_steps = n
        self.timesteps = ts
        ac = self.alphas_cumprod[ts]
        # the grid ends at sigma(alpha_bar_0), not at 0 (diffusers v0.27's
        # UniPC, unlike DPM-Solver's final_sigmas_type="zero")
        sigma_last = np.sqrt((1 - self.alphas_cumprod[0]) / self.alphas_cumprod[0])
        self.sigmas = np.concatenate([np.sqrt(1 - ac) / np.sqrt(ac), [sigma_last]])
        self._alpha_hat = 1.0 / np.sqrt(self.sigmas ** 2 + 1)
        self._sigma_hat = self.sigmas * self._alpha_hat
        self._build_step_tables()
        return self

    def _build_step_tables(self):
        """The predictor's cp_x, cp0, cp1 and the corrector's cc_x, cc0,
        cc1, cc2 per step (bh2, predict_x0: B(h) = e^h − 1 in the hh = −h
        domain).  The order warm-up and ``lower_order_final`` are folded
        into zeroed rows."""
        n = self.num_inference_steps
        sig, ah, sh = self.sigmas, self._alpha_hat, self._sigma_hat

        def lam(j):
            return np.log(ah[j]) - np.log(sh[j]) if sig[j] > 0 else np.inf

        def bh2_coeffs(hh):
            """(h_phi_1, B_h, b1, b2) of scheduling_unipc_multistep.py."""
            h_phi_1 = np.expm1(hh)
            b_h = h_phi_1
            h_phi_k = h_phi_1 / hh - 1.0
            b1 = h_phi_k / b_h
            h_phi_k = h_phi_k / hh - 0.5
            return h_phi_1, b_h, b1, h_phi_k * 2.0 / b_h

        cp_x, cp0, cp1, cc_x, cc0, cc1, cc2 = (np.zeros((n,)) for _ in range(7))
        # the predictor's order per step: warm-up from 1, clamped to the
        # steps left with lower_order_final
        orders, lower = [], 0
        for i in range(n):
            o = min(2, n - i) if self.lower_order_final else 2
            orders.append(min(o, lower + 1))
            lower = min(lower + 1, 2)

        for i in range(n):
            s, t = i, i + 1
            if sig[t] == 0:
                cp_x[i], cp0[i], cp1[i] = 0.0, 1.0, 0.0
            else:
                h = lam(t) - lam(s)
                h_phi_1, b_h, _, _ = bh2_coeffs(-h)
                cp_x[i] = sh[t] / sh[s]
                cp0[i] = -ah[t] * h_phi_1
                if orders[i] == 2:
                    r0 = (lam(i - 1) - lam(s)) / h
                    cp1[i] = -ah[t] * b_h * 0.5 / r0  # rhos_p = [0.5]
            if i > 0:
                # the corrector over i-1 -> i at the previous step's order
                hc = lam(i) - lam(i - 1)
                h_phi_1c, b_hc, b1, b2 = bh2_coeffs(-hc)
                cc_x[i] = sh[i] / sh[i - 1]
                cc0[i] = -ah[i] * h_phi_1c
                if orders[i - 1] >= 2 and i >= 2:
                    r0c = (lam(i - 2) - lam(i - 1)) / hc
                    rhos = np.linalg.solve(np.array([[1.0, 1.0], [r0c, 1.0]]), np.array([b1, b2]))
                    cc1[i] = -ah[i] * b_hc * rhos[0] / r0c
                    cc2[i] = -ah[i] * b_hc * rhos[1]
                else:
                    cc2[i] = -ah[i] * b_hc * 0.5  # the order-1 corrector: rhos_c = [0.5]
        self._cp = (cp_x, cp0, cp1)
        self._cc = (cc_x, cc0, cc1, cc2)

    def init_state(self, shape, dtype=torch.float32, device="cpu") -> UniPCState:
        def z():
            return torch.zeros(shape, dtype=dtype, device=device)

        return UniPCState(m_prev=z(), m_prev2=z(), last_sample=z())

    def tables(self, device="cpu"):
        """The step tables as float32 tensors on ``device``."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        (cp_x, cp0, cp1), (cc_x, cc0, cc1, cc2) = self._cp, self._cc
        return dict(timesteps=f32(self.timesteps), alpha_hat=f32(self._alpha_hat[:-1]),
                    sigma_hat=f32(self._sigma_hat[:-1]), cp_x=f32(cp_x), cp0=f32(cp0),
                    cp1=f32(cp1), cc_x=f32(cc_x), cc0=f32(cc0), cc1=f32(cc1), cc2=f32(cc2))

    def step(self, state: UniPCState, model_output, step_index: int, sample):
        return self.step_from_tables(self.tables(sample.device), state, model_output,
                                     step_index, sample, prediction_type=self.prediction_type)

    @staticmethod
    def step_from_tables(tables, state: UniPCState, model_output, step_index: int, sample,
                         prediction_type: str = "epsilon"):
        """One UniPC step over a :meth:`tables` dict, in float32: correct the
        previous interval with the fresh model output (not at step 0), then
        predict the next sample; returns (x_next, new state)."""
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
        if i == 0:
            x_corr = x
        else:
            x_corr = (tables["cc_x"][i] * state.last_sample.float()
                      + tables["cc0"][i] * state.m_prev
                      + tables["cc1"][i] * (state.m_prev2 - state.m_prev)
                      + tables["cc2"][i] * (x0 - state.m_prev))
        x_next = (tables["cp_x"][i] * x_corr + tables["cp0"][i] * x0
                  + tables["cp1"][i] * (state.m_prev - x0))
        return x_next.to(sample.dtype), UniPCState(m_prev=x0, m_prev2=state.m_prev,
                                                   last_sample=x_corr)
