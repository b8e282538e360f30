"""Spatially tiled encode and decode of the Wan VAEs (VAE38 and, by the
config's ``arch``, the Wan2.1 VAE) with linear feather blending (port of
fairygen_tpu/models/wan/vae_tiling.py).

Overlapping spatial tiles go through the (streamed) causal VAE one at a
time and are blended with per-axis linear ramps ``(arange(border)+1)/border``
combined by their minimum.  The blend stays on the tiles' device in fp32:
copying each decoded tile to the host would move a whole fp32 video per
tile.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .vae import WanVAEConfig, vae38_decode, vae38_encode


def _build_mask(h: int, w: int, is_bound, border_width) -> np.ndarray:
    """(h, w) blend weights: linear ramps on the sides that are not the
    image's bounds, min-combined."""

    def ramp1d(length, left_bound, right_bound, border):
        x = np.ones((length,), np.float32)
        if border > 0:
            if not left_bound:
                x[:border] = (np.arange(border) + 1) / border
            if not right_bound:
                x[-border:] = np.flip((np.arange(border) + 1) / border)
        return x

    hm = ramp1d(h, is_bound[0], is_bound[1], border_width[0])
    wm = ramp1d(w, is_bound[2], is_bound[3], border_width[1])
    return np.minimum(hm[:, None], wm[None, :])


def _tile_tasks(H, W, size, stride):
    size_h, size_w = size
    stride_h, stride_w = stride
    tasks = []
    for h in range(0, H, stride_h):
        if h - stride_h >= 0 and h - stride_h + size_h >= H:
            continue
        for w in range(0, W, stride_w):
            if w - stride_w >= 0 and w - stride_w + size_w >= W:
                continue
            tasks.append((h, min(h + size_h, H + size_h), w, min(w + size_w, W + size_w)))
    return tasks


def _blend_add(values, weight, tile, mask_np, ph, pw):
    mask = torch.from_numpy(mask_np).to(tile.device)
    th, tw = tile.shape[-2:]
    values[..., ph:ph + th, pw:pw + tw] += tile * mask
    weight[..., ph:ph + th, pw:pw + tw] += mask


def vae38_tiled_decode(params, cfg: WanVAEConfig, latents,
                       tile_size: Tuple[int, int] = (30, 52),
                       tile_stride: Tuple[int, int] = (15, 26),
                       streaming: bool = True, mesh=None):
    """latents (B, z, T, H, W) -> video (B, 3, (T-1)*4+1, H*f, W*f) in fp32,
    clamped to [-1, 1]; tile sizes in latent units (the defaults, 30 x 52,
    are one 480x832 frame).  Tiles of one shape decode as one batch."""
    if mesh is not None:
        raise NotImplementedError("mesh= (tiles over devices) waits for parallel/ on "
                                  "torch.distributed, ROADMAP Queue 1 item 9")
    B, _, T, H, W = latents.shape
    f = cfg.upsampling_factor
    size_h, size_w = tile_size
    stride_h, stride_w = tile_stride
    dev = latents.device
    values = torch.zeros((B, 3, (T - 1) * 4 + 1, H * f, W * f), dtype=torch.float32, device=dev)
    weight = torch.zeros((1, 1, 1, H * f, W * f), dtype=torch.float32, device=dev)

    groups: dict = {}
    for h, _, w, _ in _tile_tasks(H, W, tile_size, tile_stride):
        h_, w_ = min(h + size_h, H), min(w + size_w, W)
        groups.setdefault((h_ - h, w_ - w), []).append((h, h_, w, w_))
    for group in groups.values():
        batch = torch.cat([latents[:, :, :, h:h_, w:w_] for h, h_, w, w_ in group], dim=0)
        dec = vae38_decode(params, cfg, batch, streaming=streaming, clamp=False).float()
        for i, (h, h_, w, w_) in enumerate(group):
            d = dec[i * B:(i + 1) * B]
            mask = _build_mask(d.shape[-2], d.shape[-1], is_bound=(h == 0, h_ >= H, w == 0, w_ >= W),
                               border_width=((size_h - stride_h) * f, (size_w - stride_w) * f))
            _blend_add(values, weight, d, mask, h * f, w * f)
    return (values / weight).clamp(-1, 1)


def vae38_tiled_encode(params, cfg: WanVAEConfig, video,
                       tile_size: Tuple[int, int] = (34, 34),
                       tile_stride: Tuple[int, int] = (18, 16),
                       streaming: bool = True):
    """video (B, 3, T, H, W) -> fp32 latents; tile sizes in latent units
    (scaled to pixels by the upsampling factor)."""
    B, _, T, H, W = video.shape
    f = cfg.upsampling_factor
    size = (tile_size[0] * f, tile_size[1] * f)
    stride = (tile_stride[0] * f, tile_stride[1] * f)
    dev = video.device
    values = torch.zeros((B, cfg.z_dim, (T - 1) // 4 + 1, H // f, W // f), dtype=torch.float32,
                         device=dev)
    weight = torch.zeros((1, 1, 1, H // f, W // f), dtype=torch.float32, device=dev)
    for h, _, w, _ in _tile_tasks(H, W, size, stride):
        h_, w_ = min(h + size[0], H), min(w + size[1], W)
        z = vae38_encode(params, cfg, video[:, :, :, h:h_, w:w_], streaming=streaming).float()
        mask = _build_mask(z.shape[-2], z.shape[-1], is_bound=(h == 0, h_ >= H, w == 0, w_ >= W),
                           border_width=((size[0] - stride[0]) // f, (size[1] - stride[1]) // f))
        _blend_add(values, weight, z, mask, h // f, w // f)
    return values / weight
