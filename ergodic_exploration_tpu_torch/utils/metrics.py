"""Structured per-step metrics (port of
``ergodic_exploration_tpu/utils/metrics.py``): batched ``StepDiagnostics``
of tensors (or arrays) reduce to a flat dict of floats per engine step,
ready for logging or JSONL dumps. Reading a tensor here copies it to the
host, so call it at logging cadence, not inside the tick loop.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch


def _np(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def summarize(diag, elapsed_s: Optional[float] = None) -> dict:
    """Reduce a (batched or per-tick-stacked) StepDiagnostics to floats.

    Works on (S,)-shaped replan output and (T, S)-shaped explore output.
    """
    em = _np(diag.ergodic_metric, np.float64)
    active, code = _np(diag.dwa_active), _np(diag.collision_code)
    out = {
        "ergodic_metric_mean": float(em.mean()),
        "ergodic_metric_p50": float(np.median(em)),
        "ergodic_metric_max": float(em.max()),
        "barrier_cost_mean": float(_np(diag.barrier_cost, np.float64).mean()),
        "dwa_fallback_rate": float(active.astype(np.float64).mean()),
        # infeasible AMONG ACTIVE fallbacks: dwa_feasible means something
        # only where the emitted control came from DWA
        "dwa_infeasible_rate": float((active & ~_np(diag.dwa_feasible)).astype(np.float64).mean()),
        "diverged_rate": float(_np(diag.diverged, np.float64).mean()),
        "orbit_reset_rate": float(_np(diag.orbit_reset, np.float64).mean()),
        "collision_warn_rate": float((code == 1).mean()),
        "collision_crash_rate": float((code >= 2).mean()),
        "solves": int(em.size),
    }
    if elapsed_s is not None and elapsed_s > 0:
        out["elapsed_s"] = float(elapsed_s)
        out["solves_per_s"] = float(em.size / elapsed_s)
    return out


class MetricsLogger:
    """Tiny JSONL metrics sink with wall-clock timing between steps."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t_last = time.perf_counter()
        self.history: list = []

    def log(self, diag, **extra) -> dict:
        now = time.perf_counter()
        rec = summarize(diag, elapsed_s=now - self._t_last)
        self._t_last = now
        rec.update(extra)
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
