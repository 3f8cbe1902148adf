"""Timing, trace, span and counter helpers (port of
``ergodic_exploration_tpu/utils/profiling.py``; SURVEY.md section 6, tracing
row).

PyTorch returns from a CUDA call before the device has run it, so a host
clock around one call measures the enqueue. :func:`time_chained` times a
chain of N dependent calls: on a CUDA device between two CUDA events, on the
CPU by the host clock, after one warm-up call and ending with the device
synchronised.

Spans: :func:`spanned` decorates a function whose every call is a span (the
engine's entry calls, and inside them the mapping loop's per-call inputs and
the graph cache's lookup, copy-in and copy-out);
:meth:`~ergodic_exploration_tpu_torch.utils.graphs.Static.run` enters its
capture or replay span itself, behind the same check. A span
names a stretch of host work for a ``torch.profiler`` that is recording;
with none recording it costs one flag check (:func:`recording`). A span is
a host event of the profiler, on the clock of its CUDA trace, and its parent
is the span it runs in, so a call's spans hang under its entry span. It is
recorded at the scope of an operator (:data:`record_span`), not of a user
annotation, so the profiler draws no copy of it on the device's timeline (a
``record_function`` span would cover the device work launched inside it
there). No span opens inside a function that a CUDA graph captures: they
wrap a capture or a replay from the host. No span name starts with ``cu``
(a trace reader counts those host events as CUDA runtime calls).

Counters: :data:`COUNTS`, always on, counts graphs made, operand sets
built, kernel libraries loaded and the bytes the graphs' buffers copy in and
out (its users add to it in place); :func:`counters` returns them with the
kernel wrappers' launches, summed and by variant, one snapshot to difference
around a window.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def _record_function_fast():
    """The profiler's operator-scope record function, a torch-private class
    (``torch._C._profiler._RecordFunctionFast``), resolved once at import."""
    try:
        return torch._C._profiler._RecordFunctionFast
    except AttributeError:
        raise ImportError(
            f"torch {torch.__version__} has no torch._C._profiler._RecordFunctionFast, which "
            "the port's spans record with (utils/profiling.py)") from None


record_span = _record_function_fast()


def recording() -> bool:
    """Whether a ``torch.profiler`` records now: the one check a span costs
    when none does."""
    return _autograd_profiler._is_profiler_enabled


def spanned(name: str):
    """Decorator: every call of the function is the span ``name`` while a
    profiler records (module docstring)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with record_span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

# graphs_made: a graph made for a static entry (it captures at its first call);
# operand_builds: an operand set built on a miss of the engine's geometry
# caches; libraries_loaded: a kernel library compiled or loaded;
# copy_in_bytes / copy_out_bytes: the bytes the graphs' buffers took in from
# their sources and handed out as a call's results.
COUNTS = {"graphs_made": 0, "operand_builds": 0, "libraries_loaded": 0,
          "copy_in_bytes": 0, "copy_out_bytes": 0}


def counters() -> dict:
    """A snapshot of :data:`COUNTS` and of each kernel wrapper's launches:
    ``launches.<wrapper>``, its variants summed, and
    ``launches.<wrapper>.<variant>`` for each variant (the form a launch
    took: E's one-block or many-block form, M's placement)."""
    from ergodic_exploration_tpu_torch.utils.graphs import named_kernel_wrappers

    out = dict(COUNTS)
    for name, w in named_kernel_wrappers().items():
        out[f"launches.{name}"] = sum(w.launches.values())
        out.update({f"launches.{name}.{v}": n for v, n in w.launches.items()})
    return out
