"""TeaCache coefficient calibration (port of
fairygen_tpu/utils/tea_cache_calibration.py).

Run the full (uncached) DiT over denoise trajectories and record, per step
transition, x = the relative L1 drift of ``t_mod`` (what the runtime gate
measures) and y = the relative L1 drift of the model output (what skipping
a step costs), then least-squares fit the degree-4 polynomial x -> y.  The
fitted entry, registered under a model id, makes
``pipe(tea_cache_l1_thresh=..., tea_cache_model_id=<id>)`` thresholds mean
accumulated predicted relative output error for that model.

    coeffs, pairs = calibrate_wan_tea_cache(params, cfg, latents, contexts)
    register_tea_cache_coefficients("Wan2.2-TI2V-5B", coeffs)

or ``python -m fairygen_tpu_torch.tools.calibrate_tea_cache`` from
checkpoint files.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tea_cache import TEACACHE_COEFFICIENTS


def register_tea_cache_coefficients(model_id: str, coefficients: Sequence[float]):
    """Install (or override) a coefficient entry; the pipeline's
    ``tea_cache_model_id=`` then accepts ``model_id``."""
    TEACACHE_COEFFICIENTS[model_id] = [float(c) for c in coefficients]


def fit_tea_cache_coefficients(x_drift: np.ndarray, y_drift: np.ndarray,
                               deg: int = 4) -> List[float]:
    """Least-squares polynomial fit, highest power first (as the gate's
    polynomial and the published tables)."""
    x = np.asarray(x_drift, np.float64)
    y = np.asarray(y_drift, np.float64)
    if len(x) <= deg:
        raise ValueError(f"need more than {deg} (x, y) pairs to fit a degree-{deg} polynomial, "
                         f"got {len(x)} — calibrate over more steps")
    return [float(c) for c in np.polyfit(x, y, deg)]


def _rel_l1(curr: np.ndarray, prev: np.ndarray) -> float:
    num = float(np.abs(curr.astype(np.float64) - prev.astype(np.float64)).mean())
    den = float(np.abs(prev.astype(np.float64)).mean())
    return num / max(den, 1e-12)


@torch.no_grad()
def capture_wan_drift_pairs(params, cfg, latents, context, *, num_inference_steps: int = 50,
                            sigma_shift: float = 5.0,
                            fuse_vae_embedding_in_latents: Optional[bool] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """One full (uncached) flow-match rollout from ``latents`` (B, C, F, H,
    W) with ``context`` (B, L, text_dim); returns (xs, ys), one pair per
    step transition (num_inference_steps - 1).  The latents stay in their
    dtype (the step size in fp32)."""
    from ..diffusion.flow_match import FlowMatchScheduler
    from ..models.wan.dit import time_embedding, wan_dit_forward

    if fuse_vae_embedding_in_latents is None:
        fuse_vae_embedding_in_latents = cfg.fuse_vae_embedding_in_latents
    sched = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps, shift=sigma_shift)
    sigmas = np.append(sched.sigmas, 0.0).astype(np.float32)
    timesteps = sched.timesteps.astype(np.float32)
    lat, dev = latents, latents.device
    prev_tmod = prev_out = None
    xs, ys = [], []
    for i in range(num_inference_steps):
        t = torch.full((lat.shape[0],), float(timesteps[i]), dtype=torch.float32, device=dev)
        if cfg.seperated_timestep and fuse_vae_embedding_in_latents:
            # the gate sees the two-segment t_mod of the fused first frame
            uniq_t = torch.stack([torch.zeros_like(t, dtype=lat.dtype), t.to(lat.dtype)], 1)
            _, t_mod = time_embedding(params, cfg, uniq_t)
        else:
            _, t_mod = time_embedding(params, cfg, t)
        v = wan_dit_forward(params, cfg, lat, t, context,
                            fuse_vae_embedding_in_latents=fuse_vae_embedding_in_latents)
        dt = torch.tensor(float(sigmas[i + 1] - sigmas[i]), dtype=torch.float32, device=dev)
        lat = (lat.float() + v.to(lat.dtype).float() * dt).to(lat.dtype)
        t_mod_np = t_mod.float().cpu().numpy()
        v_np = v.float().cpu().numpy()
        if prev_tmod is not None:
            xs.append(_rel_l1(t_mod_np, prev_tmod))
            ys.append(_rel_l1(v_np, prev_out))
        prev_tmod, prev_out = t_mod_np, v_np
    return np.asarray(xs), np.asarray(ys)


def calibrate_wan_tea_cache(params, cfg, latents_list, contexts_list, *,
                            num_inference_steps: int = 50, sigma_shift: float = 5.0,
                            deg: int = 4) -> Tuple[List[float], Tuple[np.ndarray, np.ndarray]]:
    """Calibrate over several (noise, context) trajectories; returns the
    coefficients and the pooled (xs, ys)."""
    all_x, all_y = [], []
    for lat, ctx in zip(latents_list, contexts_list):
        x, y = capture_wan_drift_pairs(params, cfg, lat, ctx,
                                       num_inference_steps=num_inference_steps,
                                       sigma_shift=sigma_shift)
        all_x.append(x)
        all_y.append(y)
    xs, ys = np.concatenate(all_x), np.concatenate(all_y)
    return fit_tea_cache_coefficients(xs, ys, deg=deg), (xs, ys)
