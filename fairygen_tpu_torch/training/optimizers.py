"""Optimizers of the trainers (port of fairygen_tpu/training/optimizers.py).

Each is an object with ``init(params) -> state`` and ``update(params,
grads, state)``, which updates the list of tensors ``params`` in place
(the JAX package returns new arrays; in place saves a copy of the trainable
state).  The arithmetic is optax's, so the updates equal the JAX package's
to fp32 rounding:

* AdamW: β = 0.9 / 0.999, ε = 1e-8, bias-corrected moments,
  u = m̂ / (√v̂ + ε) + wd·p, p ← p − lr·u (decoupled decay);
* SGD: p ← p − lr·g;
* Adafactor: ``optax.adafactor(lr, weight_decay_rate=wd or None)`` with
  optax's defaults (see :class:`Adafactor`);
* ``grad_clip_norm`` c: every gradient times c/‖g‖ when the global norm
  ‖g‖ over all of them is at least c (optax's ``clip_by_global_norm``),
  before the optimizer.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

OPTIMIZERS = ("adamw", "adafactor", "sgd")


def _clip(grads, max_norm):
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if bool(norm < max_norm):
        return grads
    return [(g / norm.to(g.dtype)) * max_norm for g in grads]


class AdamW:
    def __init__(self, learning_rate, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8,
                 grad_clip_norm=None):
        self.lr, self.wd, self.b1, self.b2, self.eps = learning_rate, weight_decay, b1, b2, eps
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: List[torch.Tensor]):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state):
        if self.grad_clip_norm:
            grads = _clip(grads, self.grad_clip_norm)
        state["count"] += 1
        c1 = 1 - self.b1 ** state["count"]
        c2 = 1 - self.b2 ** state["count"]
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.sub_(self.lr * (u + self.wd * p))
        return state


class SGD:
    def __init__(self, learning_rate, grad_clip_norm=None):
        self.lr, self.grad_clip_norm = learning_rate, grad_clip_norm

    def init(self, params):
        return {}

    @torch.no_grad()
    def update(self, params, grads, state):
        if self.grad_clip_norm:
            grads = _clip(grads, self.grad_clip_norm)
        for p, g in zip(params, grads):
            p.sub_(self.lr * g)
        return state


class Adafactor:
    """optax.adafactor with its defaults and no momentum, per tensor:

    * step t (from 0): decay β_t = 1 − (t+1)^−0.8, g² = g·g + 1e-30;
    * factored (the two largest dims both ≥ ``min_dim_size_to_factor``,
      128): row and column means of g² decayed into r and c,
      u = g · (r / mean(r))^−½ · c^−½; otherwise v = β_t·v + (1−β_t)·g²,
      u = g · v^−½;
    * u / max(1, rms(u) / 1.0) (``clipping_threshold``), times lr, times
      max(rms(p), 1e-3) (``multiply_by_parameter_scale``), plus wd·p
      (``weight_decay_rate``, not scaled by lr), then p ← p − u.

    A rank-32 LoRA A (3072, 32) is unfactored: 32 < 128."""

    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    CLIPPING_THRESHOLD = 1.0
    EPS = 1e-30
    MIN_SCALE = 1e-3  # scale_by_param_block_rms's floor

    def __init__(self, learning_rate, weight_decay_rate=None, grad_clip_norm=None):
        self.lr, self.wd, self.grad_clip_norm = learning_rate, weight_decay_rate, grad_clip_norm

    def factored_dims(self, shape):
        """(the second-largest dim, the largest) to reduce over, or None
        (optax's ``_factored_dims``: a stable argsort of the shape)."""
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: shape[i])
        if shape[order[-2]] < self.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return order[-2], order[-1]

    def init(self, params: List[torch.Tensor]):
        state = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = self.factored_dims(p.shape)
            if dims is None:
                state["v_row"].append(None)
                state["v_col"].append(None)
                state["v"].append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"].append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
                state["v_col"].append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
                state["v"].append(None)
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        if self.grad_clip_norm:
            grads = _clip(grads, self.grad_clip_norm)
        # β_t and 1 − β_t rounded to fp32 as optax computes them
        one = np.float32(1.0)
        beta = one - np.float32(state["count"] + 1) ** np.float32(-self.DECAY_RATE)
        beta, keep = float(beta), float(one - beta)
        for i, (p, g) in enumerate(zip(params, grads)):
            g2 = g * g + self.EPS
            dims = self.factored_dims(p.shape)
            if dims is None:
                v = state["v"][i]
                v.mul_(beta).add_(keep * g2)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr, vc = state["v_row"][i], state["v_col"][i]
                vr.mul_(beta).add_(keep * g2.mean(d0))
                vc.mul_(beta).add_(keep * g2.mean(d1))
                red = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(red, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            u = u / torch.clamp(u.pow(2).mean().sqrt() / self.CLIPPING_THRESHOLD, min=1.0)
            u = u * self.lr
            rms = p.pow(2).mean().sqrt()
            u = u * torch.where(rms <= self.MIN_SCALE, torch.full_like(rms, self.MIN_SCALE), rms)
            if self.wd is not None:
                u = u + self.wd * p
            p.sub_(u)
        state["count"] += 1
        return state


def make_optimizer(name: str = "adamw", learning_rate: float = 1e-4,
                   weight_decay: float = 0.01, grad_clip_norm: Optional[float] = None):
    """The optimizer the train step consumes."""
    if name == "adamw":
        return AdamW(learning_rate, weight_decay, grad_clip_norm=grad_clip_norm)
    if name == "sgd":
        return SGD(learning_rate, grad_clip_norm=grad_clip_norm)
    if name == "adafactor":
        return Adafactor(learning_rate, weight_decay if weight_decay else None,
                         grad_clip_norm=grad_clip_norm)
    raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {name!r}")
