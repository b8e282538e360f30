"""SDXL few-step distillation, LCM and direct rollout-match (port of
fairygen_tpu/training/distill.py ``ddim_tables``, ``sdxl_teacher_rollout``,
``sdxl_student_rollout``, ``make_sdxl_distill_train_step`` and
``rollout_psnr``).

The Wan-side distillation is ``train_step.make_wan_distill_train_step``.
This is its SDXL analogue: distill the 50-step ε-prediction teacher into a
student whose 4-8 step LCM rollout reproduces the teacher's full rollout.

* ``method="direct"``: the student's few-step LCM rollout from noise must
  match the frozen teacher's full DDIM rollout from the same noise;
  gradients flow through every student step.
* ``method="consistency"``: latent consistency distillation.  Data
  latents are noised to a random origin-grid timestep, the frozen teacher
  takes one DDIM step back along the grid, and the student's
  boundary-scaled consistency function must agree between the two points
  (a stop-gradient target, no EMA, no CFG augmentation).

The teacher's sweeps and the target run without a gradient.  On the card
the student's sweeps under a gradient run K6a, K6b and K6c of its
attention (bf16 at head dim 64 for the bf16 SDXL UNet), the others K5 and
K4's forms.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.lcm import LCMScheduler
from .train_step import _trainer

__all__ = ["ddim_tables", "sdxl_teacher_rollout", "sdxl_student_rollout",
           "make_sdxl_distill_train_step", "rollout_psnr"]


def ddim_tables(num_steps: int, scheduler: Optional[LCMScheduler] = None, device="cpu"):
    """Deterministic DDIM tables on the diffusers "leading"-spaced grid
    (SDXL scaled-linear betas), float32 tensors on ``device``."""
    sched = scheduler or LCMScheduler()
    n_train = sched.num_train_timesteps
    t = (np.arange(num_steps) * (n_train // num_steps))[::-1].copy()
    alpha = sched.alphas_cumprod[t]
    alpha_prev = np.concatenate([sched.alphas_cumprod[t[1:]], [sched.final_alpha_cumprod]])

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return dict(timesteps=f32(t), sqrt_alpha=f32(np.sqrt(alpha)),
                sqrt_beta=f32(np.sqrt(1 - alpha)), sqrt_alpha_prev=f32(np.sqrt(alpha_prev)),
                sqrt_beta_prev=f32(np.sqrt(1 - alpha_prev)))


@torch.no_grad()
def sdxl_teacher_rollout(unet_fn: Callable, params, noise, ctx, num_steps: int = 50):
    """The frozen ε-prediction teacher: ``num_steps`` DDIM updates from pure
    noise, without a gradient.  Returns the final sample."""
    tab = ddim_tables(num_steps, device=noise.device)
    x = noise
    for i in range(num_steps):
        t = tab["timesteps"][i].expand(x.shape[0])
        eps = unet_fn(params, x, t, ctx).float()
        x32 = x.float()
        x0 = (x32 - tab["sqrt_beta"][i] * eps) / tab["sqrt_alpha"][i]
        x = (tab["sqrt_alpha_prev"][i] * x0 + tab["sqrt_beta_prev"][i] * eps).to(x.dtype)
    return x


def sdxl_student_rollout(unet_fn: Callable, params, noise, ctx, generator=None,
                         num_steps: int = 4, original_inference_steps: int = 50,
                         step_noise=None):
    """The few-step LCM rollout (``LCMScheduler.step_from_tables``),
    differentiable through every step.  The injected noise of the steps,
    (num_steps, *noise.shape), is ``step_noise`` or drawn from
    ``generator``.  Returns the last step's denoised sample."""
    sched = LCMScheduler(original_inference_steps=original_inference_steps)
    sched.set_timesteps(num_steps)
    tab = sched.tables(noise.device)
    if step_noise is None:
        step_noise = torch.randn((num_steps,) + tuple(noise.shape), generator=generator,
                                 device=noise.device, dtype=noise.dtype)
    step_noise = torch.as_tensor(step_noise).to(noise.device, noise.dtype)
    x, denoised = noise, torch.zeros_like(noise)
    for i in range(num_steps):
        t = tab["timesteps"][i].expand(x.shape[0])
        eps = unet_fn(params, x, t, ctx)
        x, denoised = sched.step_from_tables(tab, eps, i, x, step_noise[i])
    return denoised


def make_sdxl_distill_train_step(unet_fn: Callable, optimizer, teacher_params, *,
                                 method: str = "direct", num_student_steps: int = 4,
                                 num_teacher_steps: int = 50,
                                 original_inference_steps: int = 50, device="cuda"):
    """(init_state, train_step) over the student's params (every floating
    tensor trains).  ``unet_fn(params, sample, timestep, ctx) -> eps``.

    ``train_step(state, batch, generator, **draws) -> (state, loss)``; the
    batch holds ``ctx`` (whatever ``unet_fn`` takes as its conditioning)
    and ``noise`` (B, 4, H, W) for "direct" or ``latents`` (clean data
    latents) for "consistency".  The generator draws what the JAX loss
    draws from its key: "direct" the student steps' injected noise
    (``step_noise=`` replaces it); "consistency", in order, the grid index
    n in [1, original_inference_steps) and the noise (``index=`` and
    ``noise=`` replace them).  ``train_step.loss_and_grads`` gives the loss
    and the gradients without an update."""
    if method not in ("direct", "consistency"):
        raise ValueError(f"method must be 'direct' or 'consistency', got {method!r}")
    resolve_device(device)
    sched = LCMScheduler(original_inference_steps=original_inference_steps)
    # the LCM origin grid (k i - 1) and its one-step-back DDIM targets
    k = sched.num_train_timesteps // original_inference_steps
    origin_t = np.arange(1, original_inference_steps + 1) * k - 1
    prev_t = np.concatenate([[0], origin_t[:-1]])  # one grid step earlier
    alpha_o = sched.alphas_cumprod[origin_t]
    alpha_p = np.where(prev_t > 0, sched.alphas_cumprod[prev_t], 1.0)
    scaled = origin_t.astype(np.float64) * sched.timestep_scaling
    scaled_p = prev_t.astype(np.float64) * sched.timestep_scaling
    sd2 = sched.sigma_data ** 2
    c = {key: np.asarray(v, np.float32) for key, v in dict(
        origin_t=origin_t, prev_t=prev_t, sa=np.sqrt(alpha_o), sb=np.sqrt(1 - alpha_o),
        sa_p=np.sqrt(alpha_p), sb_p=np.sqrt(1 - alpha_p), c_skip=sd2 / (scaled ** 2 + sd2),
        c_out=scaled / (scaled ** 2 + sd2) ** 0.5, c_skip_p=sd2 / (scaled_p ** 2 + sd2),
        c_out_p=scaled_p / (scaled_p ** 2 + sd2) ** 0.5).items()}

    def at(key, n):
        """The table's float32 value at grid index n, as a python float."""
        return float(c[key][n])

    def timestep(key, n, x):
        return torch.full((x.shape[0],), at(key, n), dtype=torch.float32, device=x.device)

    def loss_direct(params, batch, generator, step_noise=None):
        noise, ctx = batch["noise"], batch["ctx"]
        target = sdxl_teacher_rollout(unet_fn, teacher_params, noise, ctx, num_teacher_steps)
        student = sdxl_student_rollout(unet_fn, params, noise, ctx, generator, num_student_steps,
                                       original_inference_steps, step_noise=step_noise)
        return ((student.float() - target.float()) ** 2).mean()

    def loss_consistency(params, batch, generator, index=None, noise=None):
        x0, ctx = batch["latents"], batch["ctx"]
        if index is None:
            index = torch.randint(1, original_inference_steps, (), generator=generator,
                                  device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        n = int(index)
        eps = torch.as_tensor(noise).to(x0.device, x0.dtype)
        x_n1 = (at("sa", n) * x0.float() + at("sb", n) * eps.float()).to(x0.dtype)
        with torch.no_grad():
            # one frozen-teacher DDIM step back along the origin grid
            eps_t = unet_fn(teacher_params, x_n1, timestep("origin_t", n, x0), ctx).float()
            x0_t = (x_n1.float() - at("sb", n) * eps_t) / at("sa", n)
            x_n = (at("sa_p", n) * x0_t + at("sb_p", n) * eps_t).to(x0.dtype)
            # the target: the student at the previous grid point, with that
            # point's boundary scalings (stop-gradient)
            eps_s = unet_fn(params, x_n, timestep("prev_t", n, x0), ctx).float()
            x_ns = x_n.float()
            x0_s = (x_ns - at("sb_p", n) * eps_s) / at("sa_p", n) if at("prev_t", n) > 0 else x_ns
            target = at("c_out_p", n) * x0_s + at("c_skip_p", n) * x_ns
        # f_theta(x_{n+1}, t_{n+1}) ~= stopgrad f_theta(x_n, t_n)
        eps_o = unet_fn(params, x_n1, timestep("origin_t", n, x0), ctx).float()
        x32 = x_n1.float()
        online = at("c_out", n) * ((x32 - at("sb", n) * eps_o) / at("sa", n)) \
            + at("c_skip", n) * x32
        return ((online - target) ** 2).mean()

    return _trainer(loss_direct if method == "direct" else loss_consistency, optimizer, None)


def rollout_psnr(a, b) -> float:
    """Data-range PSNR between two rollout outputs (the student-vs-teacher
    quality gate)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    rng = b.max() - b.min()
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(rng * rng / mse))
