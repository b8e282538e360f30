"""Numpy trees to port state: what the checkpoint converters of ``models/``
share.  A converter builds a nested dict (and list) of numpy arrays in the
port's layout; :func:`to_tensors` turns it into tensors on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def to_tensors(tree, device="cuda", dtype=None):
    """Numpy leaves -> contiguous tensors on ``device``; floating leaves are
    cast to ``dtype`` when it is given (the source dtype otherwise)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = torch.from_numpy(np.ascontiguousarray(node))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.contiguous().to(dev)

    return conv(tree)


def cast_tree(tree, dtype):
    """Every leaf of a nested dict / list of tensors cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def linear(sd, name):
    """A torch Linear (or a 1x1 conv used as one) as a dense dict: weight
    (out, in[, 1, 1]) -> ``w`` (in, out), plus ``b`` when the state dict has
    the bias."""
    w = np.asarray(sd[name + ".weight"])
    p = {"w": (w[:, :, 0, 0] if w.ndim == 4 else w).T}
    if name + ".bias" in sd:
        p["b"] = np.asarray(sd[name + ".bias"])
    return p


class Init:
    """Seeded random leaves made directly on a device in one dtype."""

    def __init__(self, device, dtype, gen):
        self.device, self.dtype, self.g = device, dtype, gen

    def normal(self, shape, std):
        t = torch.randn(shape, generator=self.g, device=self.device, dtype=self.dtype)
        return t.mul_(std)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def dense(self, d_in, d_out, bias=True):
        """N(0, 1/d_in) weight (d_in, d_out), zero bias."""
        p = {"w": self.normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = self.zeros((d_out,))
        return p


def generator(device, seed):
    return torch.Generator(device).manual_seed(int(seed))
