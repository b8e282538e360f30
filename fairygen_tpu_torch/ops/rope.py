"""Rotary position embedding (port of fairygen_tpu/ops/rope.py): the 3D
tables of the video DiTs and the interleaved-pair rotation of the image DiTs.

Angle tables are built in fp64 on the host and kept as fp32 (cos, sin)
tables, as the JAX package does (upstream multiplies in complex128).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _freqs_1d(dim: int, end: int = 1024, theta: float = 10000.0) -> np.ndarray:
    """Angle table (end, dim//2) in fp64."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    return np.outer(np.arange(end, dtype=np.float64), freqs)


def precompute_freqs_3d(
    head_dim: int, end: int = 1024, theta: float = 10000.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis angle tables: (end, df/2), (end, dh/2), (end, dw/2)."""
    d_f = head_dim - 2 * (head_dim // 3)
    d_hw = head_dim // 3
    return (
        _freqs_1d(d_f, end, theta),
        _freqs_1d(d_hw, end, theta),
        _freqs_1d(d_hw, end, theta),
    )


def build_freqs_grid(freqs_3d, f: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """(2, f·h·w, d/2) fp32 (cos, sin) grid; pair-axis order [f, h, w]."""
    ff, fh, fw = freqs_3d
    gf = np.broadcast_to(ff[:f][:, None, None, :], (f, h, w, ff.shape[1]))
    gh = np.broadcast_to(fh[:h][None, :, None, :], (f, h, w, fh.shape[1]))
    gw = np.broadcast_to(fw[:w][None, None, :, :], (f, h, w, fw.shape[1]))
    grid = np.concatenate([gf, gh, gw], axis=-1).reshape(f * h * w, -1)
    cos = np.cos(grid).astype(np.float32)
    sin = np.sin(grid).astype(np.float32)
    return torch.from_numpy(np.stack([cos, sin])).to(device)


def rope_apply(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs of x (B, S, N, D) by freqs (2, S, D/2):
    out[2i] = x[2i]·cos − x[2i+1]·sin, out[2i+1] = x[2i]·sin + x[2i+1]·cos."""
    b, s, n, d = x.shape
    xf = x.float().reshape(b, s, n, d // 2, 2)
    cos = freqs[0][None, :, None, :]
    sin = freqs[1][None, :, None, :]
    x0, x1 = xf[..., 0], xf[..., 1]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    return torch.stack([o0, o1], -1).reshape(b, s, n, d).to(x.dtype)


def apply_interleaved_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE of the image DiTs (FLUX.1): x (B, L, N, D) with
    (even, odd) pairs, cos/sin (L, D/2) fp32 pair tables; the rotation runs
    in fp32 and is cast back:
    out[2i] = cos·x[2i] − sin·x[2i+1], out[2i+1] = sin·x[2i] + cos·x[2i+1]."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out_e = c * xf[..., 0] - s * xf[..., 1]
    out_o = s * xf[..., 0] + c * xf[..., 1]
    return torch.stack([out_e, out_o], -1).reshape(x.shape).to(x.dtype)
