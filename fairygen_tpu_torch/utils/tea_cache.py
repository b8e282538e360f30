"""TeaCache: skip the DiT's block stack when the timestep modulation has
drifted little (port of fairygen_tpu/utils/tea_cache.py).

The gate accumulates a per-model polynomial of the relative L1 drift of
``t_mod`` between sweeps; while the sum stays under the threshold, the
sweep reuses the hidden-state residual of the last sweep that computed.
The arithmetic is the JAX package's, in fp32: drift is
mean|t_mod - prev| / max(mean|prev|, 1e-12); the polynomial runs
highest power first; the first and the last step always compute; the
accumulator resets on every computed step; the step counter wraps at
``num_inference_steps``.  The state is a dataclass of tensors on the
sweep's device.  The skip decision is one boolean read on the host once a
sweep (one device synchronisation), since the port runs the block stack or
skips it in Python, where the JAX package uses ``lax.cond``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

TEACACHE_COEFFICIENTS = {
    "Wan2.1-T2V-1.3B": [-5.21862437e04, 9.23041404e03, -5.28275948e02, 1.36987616e01, -4.99875664e-02],
    "Wan2.1-T2V-14B": [-3.03318725e05, 4.90537029e04, -2.65530556e03, 5.87365115e01, -3.15583525e-01],
    "Wan2.1-I2V-14B-480P": [2.57151496e05, -3.54229917e04, 1.40286849e03, -1.35890334e01, 1.32517977e-01],
    "Wan2.1-I2V-14B-720P": [8.10705460e03, 2.13393892e03, -3.72934672e02, 1.66203073e01, -4.17769401e-02],
    # FLUX gate: the drift signal is block 0's norm1_a-modulated hidden
    # states, not t_mod
    "FLUX.1": [4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01],
}


@dataclasses.dataclass
class TeaCacheState:
    step: torch.Tensor  # () int32
    accumulated: torch.Tensor  # () float32
    prev_modulated: torch.Tensor  # t_mod shape
    prev_residual: torch.Tensor  # hidden-state shape
    prev_hidden: torch.Tensor  # hidden-state shape


def init_tea_cache_state(t_mod_shape, hidden_shape, dtype=torch.float32,
                         device="cpu") -> TeaCacheState:
    return TeaCacheState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        accumulated=torch.zeros((), dtype=torch.float32, device=device),
        prev_modulated=torch.zeros(t_mod_shape, dtype=dtype, device=device),
        prev_residual=torch.zeros(hidden_shape, dtype=dtype, device=device),
        prev_hidden=torch.zeros(hidden_shape, dtype=dtype, device=device),
    )


def _polyval(coeffs, x):
    """Horner's rule from the highest power, as ``jnp.polyval``."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + c
    return y


def tea_cache_blocks(state: TeaCacheState, x, t_mod, blocks_fn, *,
                     model_id: Optional[str] = None, rel_l1_thresh: float = 0.0,
                     num_inference_steps: int = 50, forced_calc_mask=None):
    """Run ``blocks_fn(x)`` or reuse the cached residual.  Returns
    (x_out, new_state).  ``forced_calc_mask``: a (num_inference_steps,)
    boolean array that replaces the drift rule (step i computes iff
    mask[i]), the replay of a schedule chosen offline
    (``training.tea_cache_experiment``).  An unknown ``model_id`` raises
    KeyError."""
    if forced_calc_mask is not None:
        accumulated = state.accumulated
        should_calc = bool(torch.as_tensor(forced_calc_mask)[int(state.step)])
    else:
        if model_id not in TEACACHE_COEFFICIENTS:
            raise KeyError(f"unknown TeaCache model_id {model_id!r}; known ids: "
                           f"{sorted(TEACACHE_COEFFICIENTS)}")
        coeffs = torch.tensor(TEACACHE_COEFFICIENTS[model_id], dtype=torch.float32,
                              device=state.accumulated.device)
        prev = state.prev_modulated.float()
        drift = (t_mod.float() - prev).abs().mean()
        denom = prev.abs().mean()
        rel = drift / torch.clamp(denom, min=1e-12)
        accumulated = state.accumulated + _polyval(coeffs, rel)
        is_edge = (state.step == 0) | (state.step == num_inference_steps - 1)
        calc = is_edge | (accumulated >= rel_l1_thresh)
        accumulated = torch.where(calc, torch.zeros_like(accumulated), accumulated)
        should_calc = bool(calc)  # the one host read of the sweep

    if should_calc:
        y = blocks_fn(x)
        residual = y - x
    else:
        residual = state.prev_residual
        y = x + residual.to(x.dtype)

    step = state.step + 1
    step = torch.where(step == num_inference_steps, torch.zeros_like(step), step)
    new_state = TeaCacheState(
        step=step, accumulated=accumulated,
        prev_modulated=t_mod.to(state.prev_modulated.dtype),
        prev_residual=residual.to(state.prev_residual.dtype),
        prev_hidden=state.prev_hidden)
    return y, new_state
