"""Training runner, checkpoint logger and train-state checkpoints (port of
fairygen_tpu/training/runner.py, single process).

Adapter checkpoints hold the trainable weights only, as safetensors in the
reference's peft key layout, ``lora_B2`` included, so stage-1, stage-2 and
merged adapters round-trip between the two packages.  Train-state
checkpoints (``save_train_state``) hold what a step changes: the trainable
tensors, the optimizer state, the step and the accumulation buffers, plus
the generator's state, so a resumed run draws what the straight run would
have drawn.  The frozen base weights are not in them: a resume rebuilds the
state from the same base weights (the JAX package's orbax checkpoint holds
the whole tree).  Multi-process data feeding and ``mesh=`` are not ported.
"""
from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.io import save_safetensors
from ..device import resolve_device

_NAMES = {
    ("self_attn", "q"): "self_attn.q", ("self_attn", "k"): "self_attn.k",
    ("self_attn", "v"): "self_attn.v", ("self_attn", "o"): "self_attn.o",
    ("cross_attn", "q"): "cross_attn.q", ("cross_attn", "k"): "cross_attn.k",
    ("cross_attn", "v"): "cross_attn.v", ("cross_attn", "o"): "cross_attn.o",
    ("ffn", "fc1"): "ffn.0", ("ffn", "fc2"): "ffn.2",
}


def _np(t):
    return t.detach().float().cpu().numpy()


def wan_lora_state_dict(params, *, include_b2: bool = True,
                        prefix: str = "") -> Dict[str, np.ndarray]:
    """Adapter weights in the reference (peft) key layout,
    '<prefix>blocks.N.<module>.lora_{A,B}.default.weight' (+
    '.lora_B2.weight' with ``include_b2``), torch layout (out, in), fp32
    numpy."""
    out = {}
    for (sub, proj), name in _NAMES.items():
        for i, blk in enumerate(params["blocks"]):
            ap = blk.get(sub, {}).get(proj, {}).get("lora")
            if ap is None:
                continue
            base = f"{prefix}blocks.{i}.{name}"
            out[f"{base}.lora_A.default.weight"] = _np(ap["A"]).T
            out[f"{base}.lora_B.default.weight"] = _np(ap["B"]).T
            if include_b2 and "B2" in ap:
                out[f"{base}.lora_B2.weight"] = _np(ap["B2"]).T
    return out


class ModelLogger:
    """Trainable-only checkpoints every ``save_steps`` steps and at the end
    of each epoch (upstream logger.py:13-53).

    ``remove_prefix_in_ckpt`` strips that prefix from the keys;
    ``state_dict_fn(params) -> {name: array}`` picks what is saved (default
    :func:`wan_lora_state_dict`).  With ``async_save`` the state dict is
    taken and copied to the host on the calling thread (the one wait on the
    device), and the key mapping and the safetensors write run on one
    background thread: writes stay in order, and a failed write re-raises
    at the next save or at :meth:`flush`.  The file is the same, byte for
    byte, as a synchronous save's."""

    def __init__(self, output_path: str, remove_prefix_in_ckpt: Optional[str] = None,
                 state_dict_fn: Optional[Callable] = None, async_save: bool = False):
        self.output_path = output_path
        self.remove_prefix = remove_prefix_in_ckpt
        self.state_dict_fn = state_dict_fn or wan_lora_state_dict
        self.async_save = async_save
        self._pool = None
        self._pending = []
        os.makedirs(output_path, exist_ok=True)

    def _write(self, sd, name: str) -> str:
        if self.remove_prefix:
            p = self.remove_prefix
            sd = {(k[len(p):] if k.startswith(p) else k): v for k, v in sd.items()}
        path = os.path.join(self.output_path, name)
        save_safetensors(path, sd)
        return path

    def save(self, params, name: str) -> str:
        sd = self.state_dict_fn(params)
        if not self.async_save:
            return self._write(sd, name)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fairygen-ckpt")
        self.flush(wait=False)  # surface an earlier failed write
        # a copy: on the CPU the arrays may share memory with tensors the
        # next step updates in place
        host = {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in sd.items()}
        self._pending.append(self._pool.submit(self._write, host, name))
        return os.path.join(self.output_path, name)

    def flush(self, wait: bool = True):
        """Join (or, with wait=False, reap finished) pending async writes,
        re-raising the first failure."""
        still = []
        for f in self._pending:
            if wait or f.done():
                f.result()
            else:
                still.append(f)
        self._pending = still

    def on_step_end(self, state, step: int, save_steps: Optional[int]):
        if save_steps is not None and step % save_steps == 0:
            return self.save(state.params, f"step-{step}.safetensors")

    def on_epoch_end(self, state, epoch: int):
        return self.save(state.params, f"epoch-{epoch}.safetensors")


def save_train_state(path: str, state, generator=None):
    """Write what a train step changes (``TrainState``: the trainable
    tensors by path, the optimizer state, the step, the accumulation
    buffers) and the generator's state to ``path`` (``torch.save``; written
    to a temporary name and renamed, so a cut write leaves the old file)."""
    blob = {"paths": [list(p) for p in state.paths],
            "trainable": [t.detach().cpu() for t in state.trainable],
            "opt_state": _to(state.opt_state, "cpu"), "step": int(state.step),
            "accum": None if state.accum is None else [a.cpu() for a in state.accum],
            "micro": int(state.micro),
            "generator": None if generator is None else generator.get_state()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def restore_train_state(path: str, state, generator=None):
    """Load a :func:`save_train_state` file into ``state`` (built by the
    same ``init_state`` over the same base weights and adapters; the
    trainable tensors are written in place) and ``generator``.  Returns the
    state."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if [tuple(p) for p in blob["paths"]] != [tuple(p) for p in state.paths]:
        raise ValueError(f"{path}: its trainable tensors are not this state's")
    dev = state.trainable[0].device if state.trainable else torch.device("cpu")
    with torch.no_grad():
        for t, v in zip(state.trainable, blob["trainable"]):
            t.copy_(v)
    state.opt_state = _to(blob["opt_state"], dev)
    state.step, state.micro = blob["step"], blob["micro"]
    state.accum = None if blob["accum"] is None else [a.to(dev) for a in blob["accum"]]
    if generator is not None:
        if blob["generator"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(blob["generator"])
    return state


def _to(tree, device):
    """A copy of a tree of dicts, lists and tensors with the tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return tree


class PreemptionGuard:
    """On SIGTERM/SIGINT set a flag; the training loop saves the train
    state at the next step boundary and returns, so ``--resume_from``
    continues where the run stopped."""

    def __init__(self, checkpoint_path: str):
        self.checkpoint_path = checkpoint_path
        self.triggered = False
        self._previous = {}

    def __enter__(self):
        import signal

        def handler(signum, frame):
            self.triggered = True
            print(f"[preemption] caught signal {signum}; will checkpoint at "
                  "the next step boundary", flush=True)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        return False

    def checkpoint(self, state, generator=None):
        save_train_state(self.checkpoint_path, state, generator)
        print(f"[preemption] train state saved to {self.checkpoint_path}", flush=True)


def _on_device(batch, device):
    """A batch's tensors and numpy arrays on ``device`` (other values pass)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def _stack(batches):
    """k batches -> one, each tensor concatenated on its leading axis."""
    return {k: torch.cat([b[k] for b in batches], dim=0) if isinstance(batches[0][k],
                                                                        torch.Tensor)
            else batches[0][k] for k in batches[0]}


def launch_training_task(state, train_step: Callable, dataset: Iterable, collate_fn: Callable,
                         *, num_epochs: int = 1, save_steps: Optional[int] = None,
                         logger: Optional[ModelLogger] = None, generator=None,
                         log_every: int = 10, mesh=None, metrics_logger=None,
                         preemption_checkpoint: Optional[str] = None, shuffle: bool = False,
                         num_workers: int = 1, prefetch: int = 2,
                         global_batch_size: Optional[int] = None, device="cuda"):
    """The reference's training loop (upstream runner.py:8-47) on one card:
    ``collate_fn(sample)`` batches, moved to ``device``, the optimizer
    inside ``train_step(state, batch, generator)``, the loss printed every
    ``log_every`` steps (and logged to ``metrics_logger``).

    An indexable dataset goes through :class:`~..data.loader.PrefetchLoader`
    (``shuffle`` with a per-epoch seeded permutation, the JAX loop's,
    ``num_workers`` threads, ``prefetch`` batches ahead); a plain iterable
    is walked in order.  ``global_batch_size`` k > 1 concatenates k
    batches on the leading axis into one step, dropping a last partial
    group.  ``preemption_checkpoint``: on SIGTERM/SIGINT the loop saves the
    train state there (and the generator's) and returns."""
    if mesh is not None:
        raise NotImplementedError("mesh= (data-parallel training over torch.distributed) is "
                                  "not ported yet (ROADMAP.md Queue 1 item 9)")
    device = resolve_device(device)
    k = global_batch_size or 1
    if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__"):
        from ..data.loader import PrefetchLoader

        loader = PrefetchLoader(dataset, collate_fn, shuffle=shuffle, num_workers=num_workers,
                                prefetch=prefetch)

        def samples():  # each __iter__ is one (re-shuffled) epoch
            return iter(loader)
    else:
        def samples():
            return (collate_fn(s) for s in dataset)

    def batches():
        buf = []
        for b in samples():
            buf.append(_on_device(b, device))
            if len(buf) == k:
                yield buf[0] if k == 1 else _stack(buf)
                buf = []

    step = state.step
    last = [time.perf_counter(), step]
    guard = (PreemptionGuard(preemption_checkpoint) if preemption_checkpoint
             else contextlib.nullcontext())
    with guard:
        for epoch in range(num_epochs):
            for batch in batches():
                state, loss = train_step(state, batch, generator)
                step += 1
                if step % log_every == 0:
                    loss = float(loss)  # waits for the device
                    now = time.perf_counter()
                    sps = (step - last[1]) / max(now - last[0], 1e-9)
                    last = [now, step]
                    print(f"epoch {epoch} step {step} loss {loss:.5f} ({sps:.2f} steps/s)",
                          flush=True)
                    if metrics_logger is not None:
                        metrics_logger.log(step, loss=loss, epoch=epoch, steps_per_sec=sps)
                if logger is not None:
                    logger.on_step_end(state, step, save_steps)
                if preemption_checkpoint and guard.triggered:
                    guard.checkpoint(state, generator)
                    if logger is not None:
                        logger.flush()
                    return state
            if logger is not None:
                logger.on_epoch_end(state, epoch)
    if logger is not None:
        logger.flush()
    return state
