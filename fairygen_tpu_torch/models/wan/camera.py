"""Camera control: plücker embeddings and the SimpleAdapter (port of
fairygen_tpu/models/wan/camera.py).

Direction strings -> a camera pose trajectory -> plücker ray embeddings
(numpy geometry on the host, the JAX package's own) -> the SimpleAdapter
(pixel-unshuffle by 8, a 2x2 stride-2 conv and residual 3x3 conv blocks),
whose per-frame features are added to the DiT's patch tokens
(``wan_dit_forward(control_camera_tokens=...)``).  The convolutions are
PyTorch's (a library call on the card, as the JAX package's are XLA's),
in the tensors' dtype with fp32 accumulation, the bias added after the
cast.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import to_tensors

DEFAULT_ORIGIN = (0, 0.532139961, 0.946026558, 0.5, 0.5, 0, 0, 1, 0, 0, 0, 0, 1,
                  0, 0, 0, 0, 1, 0)


# ------------------------------------------------------------------ geometry
def generate_camera_coordinates(direction: str, length: int, speed: float = 1 / 54,
                                origin=DEFAULT_ORIGIN) -> List[List[float]]:
    """``length`` pose rows, each a step of ``speed`` along ``direction``
    (Left / Right / Up / Down / In / Out, combinable) from ``origin``."""
    coordinates = [list(origin if origin is not None else DEFAULT_ORIGIN)]
    while len(coordinates) < length:
        coor = coordinates[-1].copy()
        if "Left" in direction:
            coor[9] += speed
        if "Right" in direction:
            coor[9] -= speed
        if "Up" in direction:
            coor[13] += speed
        if "Down" in direction:
            coor[13] -= speed
        if "In" in direction:
            coor[18] -= speed
        if "Out" in direction:
            coor[18] += speed
        coordinates.append(coor)
    return coordinates


def _relative_poses(w2cs: np.ndarray, c2ws: np.ndarray) -> np.ndarray:
    target = np.eye(4)
    abs2rel = target @ w2cs[0]
    return np.stack([target] + [abs2rel @ c for c in c2ws[1:]]).astype(np.float32)


def process_pose_file(cam_params: Sequence[Sequence[float]], width=672, height=384,
                      original_pose_width=1280, original_pose_height=720) -> np.ndarray:
    """Pose rows -> plücker embedding (V, H, W, 6) fp32."""
    fx = np.array([e[1] for e in cam_params], np.float64)
    fy = np.array([e[2] for e in cam_params], np.float64)
    cx = np.array([e[3] for e in cam_params], np.float64)
    cy = np.array([e[4] for e in cam_params], np.float64)
    w2cs, c2ws = [], []
    for e in cam_params:
        m = np.eye(4)
        m[:3, :] = np.array(e[7:], np.float64).reshape(3, 4)
        w2cs.append(m)
        c2ws.append(np.linalg.inv(m))

    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    if pose_ratio > sample_ratio:
        fx = (height * pose_ratio) * fx / width
    else:
        fy = (width / pose_ratio) * fy / height

    K = np.stack([fx * width, fy * height, cx * width, cy * height], -1).astype(np.float32)
    c2w = _relative_poses(np.stack(w2cs), np.stack(c2ws))  # (V, 4, 4)

    V = len(cam_params)
    j, i = np.meshgrid(np.arange(height, dtype=np.float32),
                       np.arange(width, dtype=np.float32), indexing="ij")
    i = i.reshape(1, -1) + 0.5  # (1, HW)
    j = j.reshape(1, -1) + 0.5
    zs = np.ones_like(i)
    xs = (i - K[:, 2:3]) / K[:, 0:1] * zs
    ys = (j - K[:, 3:4]) / K[:, 1:2] * zs
    dirs = np.stack([np.broadcast_to(xs, (V, i.shape[1])),
                     np.broadcast_to(ys, (V, i.shape[1])),
                     np.broadcast_to(zs, (V, i.shape[1]))], -1)  # (V, HW, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ np.swapaxes(c2w[:, :3, :3], -1, -2)  # (V, HW, 3)
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    rays_dxo = np.cross(rays_o, rays_d)
    plucker = np.concatenate([rays_dxo, rays_d], -1).reshape(V, height, width, 6)
    return plucker.astype(np.float32)


# ----------------------------------------------------------------- adapter
@dataclasses.dataclass(frozen=True)
class SimpleAdapterConfig:
    in_dim: int = 24  # 6 plücker channels x 4 frames a latent frame
    out_dim: int = 5120
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    num_residual_blocks: int = 1


def _conv(x, p, stride=1, padding=0):
    y = F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding)
    return y + p["b"].to(x.dtype)[:, None, None]


def simple_adapter_forward(params, cfg: SimpleAdapterConfig, x):
    """x (B, C, F, H, W) plücker video -> (B, out, F, H/16, W/16): the
    per-frame control features added after the DiT's patch embed.  The
    pixel-unshuffle by 8 orders its channels (C, fh, fw), as the JAX
    package's ``pixel_unshuffle`` and torch's PixelUnshuffle do."""
    B, C, F_, H, W = x.shape
    y = F.pixel_unshuffle(x.transpose(1, 2).reshape(B * F_, C, H, W), 8)
    y = _conv(y, params["conv"], stride=tuple(cfg.stride))
    for blk in params["blocks"]:
        h = torch.relu(_conv(y, blk["conv1"], padding=1))
        y = y + _conv(h, blk["conv2"], padding=1)
    _, c, hh, ww = y.shape
    return y.reshape(B, F_, c, hh, ww).transpose(1, 2)


def convert_simple_adapter_state_dict(sd: Dict[str, np.ndarray], cfg: SimpleAdapterConfig,
                                      dtype=None, prefix: str = "", device="cuda"):
    """Upstream SimpleAdapter state dict (conv, residual_blocks.N.conv1/2,
    optionally under ``control_adapter.``) -> port params on ``device``;
    conv weights stay (out, in, kh, kw)."""
    if prefix == "" and any(k.startswith("control_adapter.") for k in sd):
        prefix = "control_adapter."

    def cw(name):
        return {"w": np.asarray(sd[prefix + name + ".weight"]),
                "b": np.asarray(sd[prefix + name + ".bias"])}

    blocks = []
    i = 0
    while f"{prefix}residual_blocks.{i}.conv1.weight" in sd:
        blocks.append({"conv1": cw(f"residual_blocks.{i}.conv1"),
                       "conv2": cw(f"residual_blocks.{i}.conv2")})
        i += 1
    return to_tensors({"conv": cw("conv"), "blocks": blocks}, device, dtype)
