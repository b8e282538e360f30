"""Two-phase training: the data_process stage (port of
fairygen_tpu/training/data_process.py).

Runs the frozen preprocessing models (VAE38 encode and UMT5) over the
dataset once and caches one ``.npz`` per sample; the train stage reads the
cache with ``UnifiedDataset(base_path=cache_dir, metadata_path=None)`` and
never loads the frozen models.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch


def _to_numpy(v):
    """Floats as float32 (``.npz`` has no bf16); integers keep their dtype."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_floating_point():
            v = v.float()
        return v.cpu().numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def launch_data_process_task(
    dataset: Iterable,
    preprocess_fn: Callable,  # sample -> dict of tensors (latents, context, ...)
    output_path: str,
    *,
    process_index: int = 0,
    num_processes: int = 1,
    log_every: int = 10,
):
    """Cache ``preprocess_fn(dataset[i])`` as ``{process_index}-{i}.npz`` for
    each i this process owns (i % num_processes == process_index).  Returns
    the number of files written."""
    os.makedirs(output_path, exist_ok=True)
    n = 0
    for data_id in range(len(dataset)):
        if data_id % num_processes != process_index:
            continue
        arrays = {k: _to_numpy(v) for k, v in preprocess_fn(dataset[data_id]).items()}
        np.savez_compressed(os.path.join(output_path, f"{process_index}-{data_id}.npz"),
                            **arrays)
        n += 1
        if n % log_every == 0:
            print(f"[data_process] rank {process_index}: {n} samples cached", flush=True)
    print(f"[data_process] rank {process_index}: done, {n} files in {output_path}")
    return n
