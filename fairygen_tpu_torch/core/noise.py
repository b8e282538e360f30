"""Seeded noise (port of fairygen_tpu/core/noise.py).

``torch_compat=True`` draws torch CPU ``randn`` from a CPU generator seeded
with ``seed`` — the form the JAX package uses for parity with upstream —
and moves it to ``device``.  Otherwise the draw comes from a generator on
``device`` itself.
"""
from __future__ import annotations

import torch


def generate_noise(shape, seed=0, dtype=torch.float32, torch_compat=False, device="cpu"):
    device = torch.device(device)
    gen_device = "cpu" if torch_compat else device
    g = torch.Generator(gen_device).manual_seed(int(seed))
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=gen_device)
    return x.to(device=device, dtype=dtype)
