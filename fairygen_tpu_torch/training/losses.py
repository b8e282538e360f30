"""Training losses (port of fairygen_tpu/training/losses.py).

* ``flow_match_sft_loss``: a uniform random timestep index within the
  [min, max] boundary fractions, rectified-flow noising, and the weighted
  MSE on the (noise − x₀) velocity target;
* ``direct_distill_loss``: the student's whole few-step rollout from noise
  matched to the clean latents, gradients through every step;
* ``trajectory_imitation_loss``: the student's velocity at each of its
  timesteps matched to finite differences of a frozen teacher's many-step
  rollout.

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


def _scalar(x, like):
    """A python number as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


def direct_distill_loss(
    model_fn: Callable,  # (params, latents, timestep, context) -> v_pred
    params,
    input_latents,
    context,
    generator=None,
    *,
    num_inference_steps: int = 4,
    sigma_shift: float = 5.0,
    noise: Optional[torch.Tensor] = None,
):
    """Full-rollout latent-match distillation (upstream
    ``diffusion/loss.py:24-33``, DirectDistillLoss): the student runs the
    whole ``num_inference_steps`` Euler trajectory from noise (drawn from
    ``generator`` unless given) and its final latents are matched to the
    clean ones by MSE; gradients flow through every step."""
    from ..diffusion.flow_match import FlowMatchScheduler

    sched = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps, shift=sigma_shift)
    sigmas = np.append(sched.sigmas, 0.0).astype(np.float32)
    timesteps = np.asarray(sched.timesteps, np.float32)
    if noise is None:
        noise = torch.randn(input_latents.shape, generator=generator,
                            device=input_latents.device)
    lat = noise.to(input_latents.dtype)
    b = lat.shape[0]
    for i in range(num_inference_steps):
        t = torch.full((b,), float(timesteps[i]), dtype=torch.float32, device=lat.device)
        v = model_fn(params, lat, t, context)
        lat = lat + v.to(lat.dtype) * _scalar(sigmas[i + 1] - sigmas[i], lat)
    return torch.mean((lat.float() - input_latents.float()) ** 2)


def trajectory_imitation_loss(
    student_fn: Callable,  # (params, latents, timestep, context) -> v
    teacher_fn: Callable,  # (latents, timestep, context) -> v  (frozen)
    params,
    noise,
    context,
    *,
    num_student_steps: int = 8,
    num_teacher_steps: int = 50,
    sigma_shift: float = 5.0,
    perceptual_fn: Optional[Callable] = None,  # (img_a, img_b) -> scalar
    decode_fn: Optional[Callable] = None,  # latents -> images for perceptual_fn
):
    """Trajectory-imitation distillation (upstream ``diffusion/loss.py:36-119``):

      1. the teacher rolls out ``num_teacher_steps`` from ``noise`` with no
         gradient, its TIMESTEPS snapped to hold the student grid (its
         sigmas are not: upstream flow_match.py:113-117 moves the timesteps
         only);
      2. at each student timestep the student's velocity is matched (MSE,
         the training weights) to the teacher's finite difference between
         the snapped trajectory points;
      3. with ``perceptual_fn`` and ``decode_fn``, the perceptual distance
         between the student rollout's decode and the teacher's final
         decode is added.  The rollout steps with the velocity detached, as
         upstream does (loss.py:104), so this term adds its value and no
         gradient.
    """
    from ..diffusion.flow_match import FlowMatchScheduler

    stu = FlowMatchScheduler("Wan").set_timesteps(num_student_steps, training=True,
                                                  shift=sigma_shift)
    tea = FlowMatchScheduler("Wan").set_timesteps(num_teacher_steps, shift=sigma_shift)
    t_tea = np.asarray(tea.timesteps).copy()
    for t in stu.timesteps:
        t_tea[int(np.argmin(np.abs(t_tea - t)))] = t
    sig_tea = np.asarray(tea.sigmas)
    b = noise.shape[0]

    def tvec(t):
        return torch.full((b,), float(np.float32(t)), dtype=torch.float32, device=noise.device)

    # 1. the teacher's rollout, no gradient
    traj = [noise]
    lat = noise
    with torch.no_grad():
        for i in range(num_teacher_steps):
            v = teacher_fn(lat, tvec(t_tea[i]), context)
            s_next = sig_tea[i + 1] if i + 1 < num_teacher_steps else 0.0
            lat = lat + v.to(lat.dtype) * _scalar(s_next - sig_tea[i], lat)
            traj.append(lat)

    # 2. the student's velocity against the teacher's finite differences
    loss = torch.zeros((), dtype=torch.float32, device=noise.device)
    weights = np.asarray(stu.linear_timesteps_weights, np.float32)
    for i, t in enumerate(stu.timesteps):
        lat_i = traj[int(np.argmin(np.abs(t_tea - t)))]
        sigma = stu.sigmas[i]
        if i + 1 >= num_student_steps:
            sigma_next, lat_next = 0.0, traj[-1]
        else:
            sigma_next = stu.sigmas[i + 1]
            lat_next = traj[int(np.argmin(np.abs(t_tea - stu.timesteps[i + 1])))]
        target = (lat_next.float() - lat_i.float()) / float(np.float32(sigma_next - sigma))
        pred = student_fn(params, lat_i, tvec(t), context)
        loss = loss + torch.mean((pred.float() - target) ** 2) * float(weights[i])

    # 3. the perceptual term: its value, no gradient (see above)
    if perceptual_fn is not None and decode_fn is not None:
        sig_stu = np.append(np.asarray(stu.sigmas), 0.0)
        with torch.no_grad():
            lat = traj[0]
            for i, t in enumerate(stu.timesteps):
                v = student_fn(params, lat, tvec(t), context)
                lat = lat + v.to(lat.dtype) * _scalar(sig_stu[i + 1] - sig_stu[i], lat)
            perceptual = torch.mean(perceptual_fn(decode_fn(lat), decode_fn(traj[-1])))
        loss = loss + perceptual
    return loss
