"""W8A8 calibration of the Wan DiT (the calibration part of
fairygen_tpu/training/quant_experiment.py).

``rollout_calibration_samples`` takes (latents, timestep, context) points
along one dense flow-match rollout, ``calibrate_wan_dit_act_amax`` runs the
real pre-block stages and each block under the channel-amax tap
(``ops.quant.activation_stats_tap``), and the result feeds
``WanVideoPipeline.quantize(act_amax=...)``.  The rollouts keep the latents
in their own dtype (the JAX package's promote bf16 latents to fp32 after
the first step); in fp32 the two agree.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..diffusion.flow_match import FlowMatchScheduler
from ..models.wan.dit import (
    WanDiTConfig,
    dit_block,
    patchify,
    text_embedding,
    time_embedding,
    wan_dit_forward,
)
from ..ops.fused_qk import build_freqs_full
from ..ops.quant import activation_stats_tap
from ..ops.rope import build_freqs_grid, precompute_freqs_3d

__all__ = ["wan_rollout", "wan_block_dense_order", "calibrate_wan_dit_act_amax",
           "rollout_calibration_samples"]


def _euler(lat, v, sigmas, i):
    """lat + v·(σ_{i+1} − σ_i) with the step size in fp32, back in lat's dtype."""
    dt = torch.tensor(float(sigmas[i + 1] - sigmas[i]), dtype=torch.float32,
                      device=lat.device)
    return (lat.float() + v.to(lat.dtype).float() * dt).to(lat.dtype)


def _schedule(num_steps, sigma_shift):
    sched = FlowMatchScheduler("Wan").set_timesteps(num_steps, shift=sigma_shift)
    return sched, np.append(sched.sigmas, 0.0).astype(np.float32), \
        sched.timesteps.astype(np.float32)


@torch.no_grad()
def wan_rollout(params, cfg: WanDiTConfig, noise, ctx, num_steps: int = 50,
                sigma_shift: float = 5.0):
    """The full flow-match Euler rollout of the DiT alone (text
    conditioning, no CFG), from ``noise``."""
    _, sigmas, timesteps = _schedule(num_steps, sigma_shift)
    x = noise
    for i in range(num_steps):
        t = torch.full((x.shape[0],), float(timesteps[i]), dtype=torch.float32,
                       device=x.device)
        x = _euler(x, wan_dit_forward(params, cfg, x, t, ctx), sigmas, i)
    return x


def wan_block_dense_order(cfg: WanDiTConfig):
    """The dense call order inside one ``dit_block`` with the context
    given (the cross-attention projects k and v after q), which maps the
    tap's entries to param paths."""
    order = [("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
             ("self_attn", "o"),
             ("cross_attn", "q"), ("cross_attn", "k"), ("cross_attn", "v")]
    if cfg.has_image_input:
        order += [("cross_attn", "k_img"), ("cross_attn", "v_img")]
    order += [("cross_attn", "o"), ("ffn", "fc1"), ("ffn", "fc2")]
    return order


@torch.no_grad()
def calibrate_wan_dit_act_amax(params, cfg: WanDiTConfig, samples):
    """Per-channel activation amax at every block dense input, max over
    ``samples`` ((latents, timestep, context) points).  The blocks run one
    by one under the tap, with the context (not hoisted cross k/v), in the
    port's forward form (the fused q/k kernels at head dim 128).  Returns
    {group: {name: (L, K) float32 numpy}} for
    ``ops.quant.quantize_wan_dit_linears(act_amax=...)``."""
    if cfg.has_image_input:
        raise NotImplementedError("the I2V configs' image branch is not ported")
    order = wan_block_dense_order(cfg)
    agg: Dict[str, Dict[str, np.ndarray]] = {}
    for latents, timestep, context in samples:
        _, t_mod = time_embedding(params, cfg, timestep)
        t_mod = t_mod[:, None]
        ctx = text_embedding(params, context)
        x, grid = patchify(params, cfg, latents)
        freqs = build_freqs_grid(precompute_freqs_3d(cfg.head_dim), *grid, device=x.device)
        freqs_full = build_freqs_full(freqs) if cfg.head_dim == 128 else None
        for i, layer in enumerate(params["blocks"]):
            tap = []
            with activation_stats_tap(tap, mode="channel_amax"):
                x = dit_block(layer, x, t_mod, freqs, freqs_full, cfg, None, ctx=ctx)
            assert len(tap) == len(order), (len(tap), len(order))
            for (g, name), (_label, amax) in zip(order, tap):
                amax = amax.cpu().numpy().astype(np.float32)
                w = layer[g][name].get("w", layer[g][name].get("w_int8"))
                assert amax.shape[0] == w.shape[0], (g, name, amax.shape, w.shape)
                store = agg.setdefault(g, {}).setdefault(
                    name, np.zeros((cfg.num_layers, amax.shape[0]), np.float32))
                store[i] = np.maximum(store[i], amax)
    return agg


@torch.no_grad()
def rollout_calibration_samples(params, cfg: WanDiTConfig, noise, ctx, rollout_steps: int = 50,
                                at_fracs=(0.2, 0.5, 0.8)):
    """(latents, timestep, context) calibration points at the fractions
    ``at_fracs`` of one dense rollout from ``noise``: the activations the
    deployed denoiser sees.  The rollout stops at the last point."""
    _, sigmas, timesteps = _schedule(rollout_steps, 5.0)
    marks = {max(1, int(rollout_steps * f)) for f in at_fracs}
    lat, samples = noise, []
    for i in range(rollout_steps):
        t = torch.full((noise.shape[0],), float(timesteps[i]), dtype=torch.float32,
                       device=noise.device)
        if i in marks:
            samples.append((lat, t, ctx))
        if len(samples) == len(marks):
            break
        lat = _euler(lat, wan_dit_forward(params, cfg, lat, t, ctx), sigmas, i)
    return samples
