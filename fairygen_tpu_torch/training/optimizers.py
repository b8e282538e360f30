"""Optimizers of the trainers (port of fairygen_tpu/training/optimizers.py).

Each is an object with ``init(params) -> state`` and ``update(params,
grads, state)``, which updates the list of tensors ``params`` in place
(the JAX package returns new arrays; in place saves a copy of the trainable
state).  The arithmetic is optax's, so the updates equal the JAX package's
to fp32 rounding:

* AdamW: β = 0.9 / 0.999, ε = 1e-8, bias-corrected moments,
  u = m̂ / (√v̂ + ε) + wd·p, p ← p − lr·u (decoupled decay);
* SGD: p ← p − lr·g;
* ``grad_clip_norm`` c: every gradient times c/‖g‖ when the global norm
  ‖g‖ over all of them is at least c (optax's ``clip_by_global_norm``).
"""
from __future__ import annotations

from typing import List, Optional

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


def make_optimizer(name: str = "adamw", learning_rate: float = 1e-4,
                   weight_decay: float = 0.01, grad_clip_norm: Optional[float] = None):
    """The optimizer the train step consumes."""
    if name == "adamw":
        return AdamW(learning_rate, weight_decay, grad_clip_norm=grad_clip_norm)
    if name == "sgd":
        return SGD(learning_rate, grad_clip_norm=grad_clip_norm)
    if name == "adafactor":
        raise NotImplementedError("adafactor is not ported yet")
    raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {name!r}")
