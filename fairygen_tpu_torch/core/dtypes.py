"""Dtype policy (port of fairygen_tpu/core/dtypes.py): parameters live in
``param_dtype`` (bf16 for the large models), compute runs in
``compute_dtype`` and the numerically sensitive ops (norms, RoPE, softmax,
time embeddings) in ``accum_dtype``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_params(self, params):
        """A tree of dicts and lists with every floating tensor in
        ``param_dtype``; other leaves are kept."""
        if isinstance(params, dict):
            return {k: self.cast_params(v) for k, v in params.items()}
        if isinstance(params, (list, tuple)):
            return type(params)(self.cast_params(v) for v in params)
        if isinstance(params, torch.Tensor) and params.is_floating_point():
            return params.to(self.param_dtype)
        return params


def default_policy() -> DTypePolicy:
    return DTypePolicy()
