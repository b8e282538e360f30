"""TeaCache operating point from a calibration trace (the schedule replay
of fairygen_tpu/training/tea_cache_experiment.py; plain numpy).

``t_mod`` depends only on the timestep, so replaying the runtime gate's
accumulator rule over a captured t_mod drift trace predicts a gated run's
skip schedule step for step, and ``pick_threshold`` searches the threshold
that computes a target fraction of the steps.
"""
from __future__ import annotations

import numpy as np

__all__ = ["simulate_calc_schedule", "pick_threshold"]


def simulate_calc_schedule(coeffs, xs, thresh: float, num_steps: int) -> np.ndarray:
    """Replay the gate over a t_mod drift trace ``xs`` (num_steps - 1
    transitions).  Returns the boolean calc mask: the first and the last
    step compute; otherwise a step computes when the accumulated
    polynomial-predicted output drift reaches ``thresh``, which resets the
    accumulator.  fp32 like the runtime gate, which computes the drift on
    the device in its own reduction order, so an accumulator within an ulp
    of the threshold can flip one step."""
    xs = np.asarray(xs, np.float32)
    c32 = np.asarray(coeffs, np.float32)
    assert len(xs) == num_steps - 1, (len(xs), num_steps)
    acc = np.float32(0.0)
    mask = [True]  # step 0: prev_modulated is zeros -> edge calc
    for i in range(1, num_steps):
        acc = np.float32(acc + np.polyval(c32, xs[i - 1]))
        calc = i == num_steps - 1 or acc >= np.float32(thresh)
        if calc:
            acc = np.float32(0.0)
        mask.append(bool(calc))
    return np.asarray(mask)


def pick_threshold(coeffs, xs, num_steps: int, target_calc_frac: float,
                   iters: int = 40) -> float:
    """Binary-search the threshold whose replayed schedule computes closest
    to ``target_calc_frac`` of the steps, from above (quality over speed on
    ties)."""
    lo, hi = 0.0, 1e3
    target = target_calc_frac * num_steps
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        n = int(simulate_calc_schedule(coeffs, xs, mid, num_steps).sum())
        if n > target:
            lo = mid  # too many calcs -> raise the threshold
        else:
            hi = mid
    return hi
