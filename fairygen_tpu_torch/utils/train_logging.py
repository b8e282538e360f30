"""Training metrics logging (port of fairygen_tpu/utils/train_logging.py).

A JSONL metrics file always, and TensorBoard events with
``report_to="tensorboard"`` through ``torch.utils.tensorboard``, which
raises where the ``tensorboard`` package is missing (the port does not fall
back to JSONL alone).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """log_dir/metrics.jsonl (+ TensorBoard events with report_to)."""

    def __init__(self, log_dir: str, report_to: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if report_to == "tensorboard":
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
