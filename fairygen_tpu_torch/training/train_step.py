"""Single-card training steps for the Wan DiT (port of
fairygen_tpu/training/train_step.py ``make_wan_sft_train_step`` and
``make_wan_distill_train_step``).

The base weights are frozen (``requires_grad=False``); only the tensors the
trainable filter selects (the LoRA adapters) get gradients and go to the
optimizer, which updates them in place.  Stage-wise element dropout on B or
B2 is a parameter transform before the forward pass.  Parallel training
(mesh, pipeline) is not ported: those arguments are refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import resolve_device
from ..diffusion.flow_match import FlowMatchScheduler
from ..models.adapters import dropout_lora_b, leaves_with_path
from ..models.wan.dit import WanDiTConfig, wan_dit_forward
from .losses import direct_distill_loss, flow_match_sft_loss, trajectory_imitation_loss


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    trainable: list  # the optimizer's tensors, in path order
    paths: list      # their paths
    accum: Optional[list] = None  # running mean of grads (accumulation)
    micro: int = 0


def _trainer(loss_fn, optimizer, trainable_filter, gradient_accumulation_steps=1):
    """(init_state, train_step) over ``loss_fn(params, batch, generator,
    **kw) -> loss``; ``train_step.loss_and_grads`` gives the loss and the
    trainable gradients (path -> tensor) without an update."""

    def init_state(params):
        trainable, paths = [], []
        for path, leaf in leaves_with_path(params):
            if not isinstance(leaf, torch.Tensor):
                continue
            train = leaf.is_floating_point() and (trainable_filter is None
                                                  or trainable_filter(path))
            leaf.requires_grad_(train)
            if train:
                trainable.append(leaf)
                paths.append(path)
        return TrainState(params=params, opt_state=optimizer.init(trainable), step=0,
                          trainable=trainable, paths=paths)

    def _grads(state, batch, generator, kw):
        loss = loss_fn(state.params, batch, generator, **kw)
        grads = torch.autograd.grad(loss, state.trainable, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def loss_and_grads(state, batch, generator=None, **kw):
        loss, grads = _grads(state, batch, generator, kw)
        return loss, dict(zip(state.paths, grads))

    def train_step(state: TrainState, batch, generator=None, **kw):
        loss, grads = _grads(state, batch, generator, kw)
        k = gradient_accumulation_steps
        if k > 1:
            if state.accum is None:
                state.accum = [torch.zeros_like(g) for g in grads]
            with torch.no_grad():
                for a, g in zip(state.accum, grads):
                    a.add_((g - a) / (state.micro + 1))
            state.micro += 1
            if state.micro < k:
                state.step += 1
                return state, loss
            grads, state.accum, state.micro = state.accum, None, 0
        state.opt_state = optimizer.update(state.trainable, grads, state.opt_state)
        state.step += 1
        return state, loss

    train_step.loss_and_grads = loss_and_grads
    return init_state, train_step


def _model_fn(dit_cfg, first_frame_clean, remat):
    def model_fn(params, noisy, timestep, context):
        return wan_dit_forward(params, dit_cfg, noisy, timestep, context,
                               fuse_vae_embedding_in_latents=first_frame_clean, remat=remat)
    return model_fn


def _refuse_parallel(mesh, pp_microbatches=None):
    if mesh is not None or pp_microbatches is not None:
        raise NotImplementedError("mesh / pipeline-parallel training is not ported yet "
                                  "(ROADMAP.md Queue 1 item 9)")


def make_wan_sft_train_step(
    dit_cfg: WanDiTConfig,
    optimizer,
    mesh=None,
    *,
    num_train_timesteps: int = 1000,
    sigma_shift: float = 5.0,
    remat=True,
    first_frame_clean: Optional[bool] = None,
    trainable_filter: Optional[Callable] = None,
    lora_b_dropout: Optional[tuple] = None,  # ("B", 0.8) stage-1 / ("B2", 0.5) stage-2
    gradient_accumulation_steps: int = 1,
    pp_microbatches: Optional[int] = None,
    device="cuda",
):
    """Build (init_state, train_step).  ``train_step(state, batch,
    generator, *, index=None, noise=None) -> (state, loss)``; batch holds
    ``latents`` (B, C, F, H, W) and ``context`` (B, L, text_dim).  The
    generator draws, in order, the dropout masks, the timestep index and
    the noise; ``index``/``noise`` replace the last two.

    ``train_step.loss_and_grads(state, batch, generator, ...)`` gives the
    loss and the trainable gradients (path -> tensor) without an update.
    With ``gradient_accumulation_steps`` k > 1 the gradients' running mean
    is applied every k-th call (optax.MultiSteps).  ``remat``: False, True
    or "offload" (``wan_dit_forward``)."""
    _refuse_parallel(mesh, pp_microbatches)
    resolve_device(device)
    scheduler = FlowMatchScheduler("Wan").set_timesteps(
        num_train_timesteps, training=True, shift=sigma_shift)
    if first_frame_clean is None:
        first_frame_clean = dit_cfg.fuse_vae_embedding_in_latents

    model_fn = _model_fn(dit_cfg, first_frame_clean, remat)

    def loss_fn(params, batch, generator, index=None, noise=None):
        if lora_b_dropout is not None:
            which, p_drop = lora_b_dropout
            params = dropout_lora_b(params, generator, p_drop, which=which)
        return flow_match_sft_loss(
            model_fn, params, batch["latents"], batch["context"], generator,
            sigmas=scheduler.sigmas, timesteps=scheduler.timesteps,
            weights=scheduler.linear_timesteps_weights, first_frame_clean=first_frame_clean,
            index=index, noise=noise)

    return _trainer(loss_fn, optimizer, trainable_filter, gradient_accumulation_steps)


def make_wan_distill_train_step(
    dit_cfg: WanDiTConfig,
    optimizer,
    mesh=None,
    *,
    method: str = "direct",  # "direct" | "trajectory"
    num_inference_steps: int = 4,
    num_teacher_steps: int = 50,
    sigma_shift: float = 5.0,
    remat=True,
    first_frame_clean: Optional[bool] = None,
    trainable_filter: Optional[Callable] = None,
    perceptual_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    device="cuda",
):
    """Few-step distillation step: the reference's ``--task direct_distill``
    (upstream train.py:59-61, DirectDistillLoss) and the
    TrajectoryImitationLoss variant.

    ``train_step(state, batch, generator, *, teacher_params=None,
    noise=None) -> (state, loss)``.  method="direct": the student rolls out
    its own ``num_inference_steps`` trajectory from noise and matches the
    batch's clean latents (gradients through every step).
    method="trajectory": the student's velocities match finite differences
    of the frozen teacher's ``num_teacher_steps`` rollout from
    ``teacher_params``.  The noise is ``noise``, else ``batch["noise"]``
    (trajectory), else drawn from ``generator``."""
    if method not in ("direct", "trajectory"):
        raise ValueError(f"method must be 'direct' or 'trajectory', got {method!r}")
    _refuse_parallel(mesh)
    resolve_device(device)
    if first_frame_clean is None:
        first_frame_clean = dit_cfg.fuse_vae_embedding_in_latents

    model_fn = _model_fn(dit_cfg, first_frame_clean, remat)

    def loss_fn(params, batch, generator, teacher_params=None, noise=None):
        if method == "direct":
            return direct_distill_loss(
                model_fn, params, batch["latents"], batch["context"], generator,
                num_inference_steps=num_inference_steps, sigma_shift=sigma_shift, noise=noise)
        if teacher_params is None:
            raise ValueError("method='trajectory' needs teacher_params")
        if noise is None:
            noise = batch.get("noise")
        if noise is None:
            lat = batch["latents"]
            noise = torch.randn(lat.shape, generator=generator, device=lat.device)
        noise = noise.to(batch["latents"].dtype)
        return trajectory_imitation_loss(
            model_fn, lambda lat, t, ctx: model_fn(teacher_params, lat, t, ctx),
            params, noise, batch["context"], num_student_steps=num_inference_steps,
            num_teacher_steps=num_teacher_steps, sigma_shift=sigma_shift,
            perceptual_fn=perceptual_fn, decode_fn=decode_fn)

    return _trainer(loss_fn, optimizer, trainable_filter)
