"""Timing and trace helpers (port of
``ergodic_exploration_tpu/utils/profiling.py``; SURVEY.md section 6, tracing
row).

PyTorch returns from a CUDA call before the device has run it, so a host
clock around one call measures the enqueue. These helpers time a chain of N
dependent calls: on a CUDA device between two CUDA events, on the CPU by the
host clock, each after one warm-up call and ending with the device
synchronised. :func:`latency_p50` differences two chain lengths to cancel
what a chain costs once (the final read).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def force_completion(tree) -> float:
    """Wait for the device to finish the first tensor of ``tree`` (nested
    tuples and NamedTuples) and read its sum back; returns the sum, so the
    read cannot be skipped."""
    leaf = _first_tensor(tree)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(leaf.sum())


def time_chained(step_fn, args, iters: int = 30, carry_index=0) -> float:
    """Seconds per call of ``step_fn`` over a serial chain.

    ``step_fn(*args)`` returns something whose ``carry_index``-th element
    (or itself, if None) feeds back as the first argument, so every call
    depends on the one before. One warm-up call, then ``iters`` chained
    calls, timed by CUDA events where the output lies on a CUDA device and
    by the host clock elsewhere.
    """
    out = step_fn(*args)
    force_completion(out)
    first = out if carry_index is None else out[carry_index]
    dev = _first_tensor(out).device
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn(first, *args[1:])
        first = out if carry_index is None else out[carry_index]
    if dev.type == "cuda":
        end.record()
        force_completion(out)
        return start.elapsed_time(end) / 1e3 / iters
    force_completion(out)
    return (time.perf_counter() - t0) / iters


def latency_p50(step_fn, args, n: int = 32, reps: int = 5) -> float:
    """Median seconds per call with the fixed cost of a chain cancelled:
    (t_chain(2n) - t_chain(n)) / n, over ``reps`` repeats."""
    samples = []
    for _ in range(reps):
        t1 = time_chained(step_fn, args, iters=n) * n
        t2 = time_chained(step_fn, args, iters=2 * n) * 2 * n
        samples.append((t2 - t1) / n)
    return float(np.median(samples))


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the CUDA
    device where there is one) into ``<logdir>/trace.json``, for Perfetto or
    chrome://tracing; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
