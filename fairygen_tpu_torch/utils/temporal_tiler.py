"""Temporal sliding-window denoising for long videos (port of
fairygen_tpu/utils/temporal_tiler.py): the denoiser runs on overlapping
temporal windows of the latent video, the outputs are blended with
trapezoid masks ``(arange(border)+0.5)/border`` in fp32 and divided by the
summed weight.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _mask_1d(length, left_bound, right_bound, border_width):
    x = np.ones((length,), np.float32)
    if border_width == 0:
        return x
    ramp = (np.arange(border_width) + 0.5) / border_width
    if not left_bound:
        x[:border_width] = ramp
    if not right_bound:
        x[-border_width:] = np.flip(ramp)
    return x


def temporal_tiled_model_fn(model_fn: Callable, latents, sliding_window_size: int,
                            sliding_window_stride: int, sliced_kwargs: Optional[dict] = None,
                            **model_kwargs):
    """``model_fn(window, **sliced, **model_kwargs)`` -> velocity of the
    window's BCTHW shape.  ``sliced_kwargs`` holds BCTHW tensors (or None)
    windowed along T with ``latents``."""
    T = latents.shape[2]
    value = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
    weight = np.zeros((1, 1, T, 1, 1), np.float32)
    border = sliding_window_size - sliding_window_stride
    sliced_kwargs = sliced_kwargs or {}
    for t in range(0, T, sliding_window_stride):
        if t - sliding_window_stride >= 0 and t - sliding_window_stride + sliding_window_size >= T:
            continue
        t_ = min(t + sliding_window_size, T)
        sliced = {k: (v[:, :, t:t_] if v is not None else None) for k, v in sliced_kwargs.items()}
        out = model_fn(latents[:, :, t:t_], **sliced, **model_kwargs).float()
        mask = _mask_1d(t_ - t, t == 0, t_ == T, border).reshape(1, 1, -1, 1, 1)
        value[:, :, t:t_] += out * torch.from_numpy(mask).to(out.device)
        weight[:, :, t:t_] += mask
    return (value / torch.from_numpy(weight).to(value.device)).to(latents.dtype)
