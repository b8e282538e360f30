"""Training runner and checkpoint logger (port of
fairygen_tpu/training/runner.py, single process).

Checkpoints hold the trainable adapter weights only, as safetensors in the
reference's peft key layout, ``lora_B2`` included, so stage-1, stage-2 and
merged adapters round-trip between the two packages.  Multi-process data
feeding, prefetching, full train-state resume and preemption handling are
not ported.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from ..core.io import save_safetensors

_NAMES = {
    ("self_attn", "q"): "self_attn.q", ("self_attn", "k"): "self_attn.k",
    ("self_attn", "v"): "self_attn.v", ("self_attn", "o"): "self_attn.o",
    ("cross_attn", "q"): "cross_attn.q", ("cross_attn", "k"): "cross_attn.k",
    ("cross_attn", "v"): "cross_attn.v", ("cross_attn", "o"): "cross_attn.o",
    ("ffn", "fc1"): "ffn.0", ("ffn", "fc2"): "ffn.2",
}


def _np(t):
    return t.detach().float().cpu().numpy()


def wan_lora_state_dict(params) -> Dict[str, np.ndarray]:
    """Adapter weights in the reference (peft) key layout,
    'blocks.N.<module>.lora_{A,B}.default.weight' (+ '.lora_B2.weight'),
    torch layout (out, in), fp32 numpy."""
    out = {}
    for (sub, proj), name in _NAMES.items():
        for i, blk in enumerate(params["blocks"]):
            ap = blk.get(sub, {}).get(proj, {}).get("lora")
            if ap is None:
                continue
            base = f"blocks.{i}.{name}"
            out[f"{base}.lora_A.default.weight"] = _np(ap["A"]).T
            out[f"{base}.lora_B.default.weight"] = _np(ap["B"]).T
            if "B2" in ap:
                out[f"{base}.lora_B2.weight"] = _np(ap["B2"]).T
    return out


class ModelLogger:
    """Trainable-only checkpoints: every ``save_steps`` steps and at the end
    of each epoch, written synchronously."""

    def __init__(self, output_path: str):
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)

    def save(self, params, name: str) -> str:
        path = os.path.join(self.output_path, name)
        save_safetensors(path, wan_lora_state_dict(params))
        return path

    def on_step_end(self, state, step: int, save_steps: Optional[int]):
        if save_steps is not None and step % save_steps == 0:
            return self.save(state.params, f"step-{step}.safetensors")

    def on_epoch_end(self, state, epoch: int):
        return self.save(state.params, f"epoch-{epoch}.safetensors")


def launch_training_task(state, train_step: Callable, dataset: Iterable, collate_fn: Callable,
                         *, num_epochs: int = 1, save_steps: Optional[int] = None,
                         logger: Optional[ModelLogger] = None, generator=None,
                         log_every: int = 10):
    """The reference's training loop as a plain single-process loop: one
    batch per sample (``collate_fn``), the optimizer inside ``train_step``,
    the loss printed every ``log_every`` steps."""
    step = state.step
    last = [time.perf_counter(), step]
    for epoch in range(num_epochs):
        for sample in dataset:
            state, loss = train_step(state, collate_fn(sample), generator)
            step += 1
            if step % log_every == 0:
                loss = float(loss)  # waits for the device
                now = time.perf_counter()
                sps = (step - last[1]) / max(now - last[0], 1e-9)
                last = [now, step]
                print(f"epoch {epoch} step {step} loss {loss:.5f} ({sps:.2f} steps/s)",
                      flush=True)
            if logger is not None:
                logger.on_step_end(state, step, save_steps)
        if logger is not None:
            logger.on_epoch_end(state, epoch)
    return state
