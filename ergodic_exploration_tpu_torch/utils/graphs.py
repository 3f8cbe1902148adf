"""CUDA graphs of the closed loops: each block of work is captured once per
shape and replayed, so the host issues one graph launch where it issued
every kernel of every tick (``torch.cuda.graphs``).

A :class:`Graph` wraps a function of no arguments that reads and writes
tensors which outlive it (the static buffers of a :class:`Static`) and
returns its per-block outputs. Its first call runs the function eagerly on a
side stream (the warm-up: it builds the kernel libraries, allocates K1's
refresh scratch, sets function attributes, creates the cuBLAS handle and
workspace of that stream, makes the tick's constants) and then captures it
on the same stream; the warm-up's results are real and are what the first
call returns. Every later call replays the graph and returns the captured
outputs, which the next replay overwrites. A capture, an instantiation or a
replay that fails raises: there is no fallback to the eager function.

Launch counts: a kernel wrapper (``K1``, ``K2``, ``K3``, ``G``, ``R``, ``E``,
``M``) counts a launch in Python where it calls its library. The warm-up's launches are
real and count as they happen. Under capture nothing launches, so the counts the
capture adds are taken back and kept as the graph's delta
(:func:`count_captured`), and every replay adds that delta again
(:func:`add_launches`): after any run the counts are the launches the device
executed.

Copy-in: a :class:`Static` copies into its buffers only the leaves whose
source changed. It records, for each leaf, the tensor it was last loaded from
and that tensor's ``_version``; the same tensor with the same version is not
copied again. An in-place write (``add_``, ``copy_``, indexing assignment,
through any view of the tensor) bumps the version, so it is seen. What
escapes it: a write through ``.data``, through DLPack or another library
that shares the storage (``t.numpy()`` on the CPU, a ctypes pointer), which
PyTorch does not count; and an inference tensor, which keeps no version, is
copied on every call. A leaf that a graph writes (the state a tick advances)
is recorded by :meth:`Static.holds` as what was last copied out of it. The
leaves that change are copied with one ``torch._foreach_copy_`` a dtype
(:func:`copy_leaves`), so a call costs a few launches, not one a leaf.

Spans and counts (``utils/profiling.py``): :meth:`GraphCache.entry` is the
span ``ee.graph.lookup`` (the inputs' signature, the key's hash, the
lookup); :meth:`Static.load` is ``ee.graph.copy_in`` and counts the bytes
it copies (``copy_in_bytes``); :meth:`Static.run` counts a graph it makes
(``graphs_made``) and calls the graph as ``ee.graph.capture`` (its first
call: the warm-up and the capture) or ``ee.graph.replay``;
:meth:`Static.copy_out` and :meth:`Static.clone_out` hand a call's results
out as ``ee.graph.copy_out`` and count their bytes (``copy_out_bytes``,
computed once per entry and key). With no profiler recording a span
costs one flag check.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from ergodic_exploration_tpu_torch.utils import profiling
from ergodic_exploration_tpu_torch.utils.profiling import COUNTS, recording, spanned


def _children(tree):
    """The sub-trees of a tuple / NamedTuple / list node, else None."""
    return tuple(tree) if isinstance(tree, (tuple, list)) else None


def leaves(tree) -> list:
    """The tensor leaves of a tree of NamedTuples, tuples and lists, in
    order; ``None`` leaves are skipped."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def signature(tree):
    """What fixes a captured launch sequence on a tree of inputs: its
    structure (node types, where a leaf is None) and each tensor's shape,
    dtype and device."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return (tuple(tree.shape), tree.dtype, tree.device)
    return (type(tree).__name__, tuple(signature(k) for k in kids))


def copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` (trees of
    one signature; :func:`copy_leaves`, a few launches for any number of
    leaves); a leaf that already is its destination is skipped."""
    pairs = [(d, s) for d, s in zip(leaves(dst), leaves(src), strict=True) if d is not s]
    if pairs:
        _foreach_copy(*zip(*pairs))


def copy_leaves(dsts: Sequence, srcs: Sequence) -> None:
    """``d.copy_(s)`` for each pair, as one ``torch._foreach_copy_`` per
    destination dtype."""
    _foreach_copy(dsts, srcs)


def _foreach_copy(dsts: Sequence, srcs: Sequence) -> None:
    groups = {}
    for d, s in zip(dsts, srcs, strict=True):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _empty_like(tree):
    """A tree of the same structure with an uninitialised contiguous tensor
    in place of each leaf."""
    from ergodic_exploration_tpu_torch.parallel import map_tree

    return map_tree(lambda t: torch.empty_like(t, memory_format=torch.contiguous_format), tree)


def clone(tree):
    """A contiguous copy of every leaf of ``tree``, in a tree of the same
    structure (:func:`copy_leaves`: a few launches for any number of leaves)."""
    new = _empty_like(tree)
    copy_leaves(leaves(new), leaves(tree))
    return new


def nbytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree``."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _version(t):
    """``t._version``, or None for a tensor that keeps no version (an
    inference tensor): such a source is copied on every load."""
    try:
        return t._version
    except RuntimeError:
        return None


class Static:
    """Static buffers for one input signature: ``load`` copies a call's
    inputs into them (those that changed, see the module docstring), a graph
    captured over them reads them on every replay."""

    def __init__(self, inputs):
        self.buffers = _empty_like(inputs)
        self._leaves = leaves(self.buffers)
        self._nbytes = [t.numel() * t.element_size() for t in self._leaves]
        self._index = {id(t): i for i, t in enumerate(self._leaves)}
        self._held = [None] * len(self._leaves)  # (weakref to the source, its version)
        self._out_bytes = {}  # copy-out key -> bytes
        self.graphs = {}  # block length -> Graph

    @spanned("ee.graph.copy_in")
    def load(self, inputs) -> int:
        """Copy the leaves of ``inputs`` that are not what their buffer
        holds; returns how many were copied."""
        dsts, srcs, n = [], [], 0
        for i, (d, s) in enumerate(zip(self._leaves, leaves(inputs), strict=True)):
            if d is s:
                continue
            v, held = _version(s), self._held[i]
            if v is not None and held is not None and held[1] == v and held[0]() is s:
                continue
            dsts.append(d)
            srcs.append(s)
            n += self._nbytes[i]
            self._held[i] = (weakref.ref(s), v)
        if dsts:
            copy_leaves(dsts, srcs)
            COUNTS["copy_in_bytes"] += n
        return len(dsts)

    def holds(self, buffers, sources=None) -> None:
        """Record what the leaves of ``buffers`` (a sub-tree of
        :attr:`buffers` that a graph wrote) now hold: the values of the
        same leaves of ``sources`` (copies of them, made since the write),
        or with ``sources`` None nothing known, so the next load copies."""
        bufs = leaves(buffers)
        srcs = [None] * len(bufs) if sources is None else leaves(sources)
        for d, s in zip(bufs, srcs, strict=True):
            v = None if s is None else _version(s)
            self._held[self._index[id(d)]] = None if v is None else (weakref.ref(s), v)

    def run(self, length: int, fn: Callable, make_graph: Callable):
        """Call the graph of ``length`` over these buffers and return its
        outputs: on a miss the graph is ``make_graph(fn)``, whose first call
        captures ``fn``."""
        g = self.graphs.get(length)
        if g is None:
            COUNTS["graphs_made"] += 1
            g = self.graphs[length] = make_graph(fn)
            name = "ee.graph.capture"
        else:
            name = "ee.graph.replay"
        if recording():
            with profiling.record_span(name):
                return g()
        return g()

    @spanned("ee.graph.copy_out")
    def copy_out(self, key, dst, src) -> None:
        """:func:`copy_into` (``dst``, ``src``): a replay's outputs into the
        caller's; ``key`` names the copy, whose bytes are counted once per
        entry."""
        copy_into(dst, src)
        self._count_out(key, src)

    @spanned("ee.graph.copy_out")
    def clone_out(self, key, tree):
        """:func:`clone` of ``tree`` (buffers or outputs of a graph) as a
        call's results; ``key`` as for :meth:`copy_out`."""
        out = clone(tree)
        self._count_out(key, tree)
        return out

    def _count_out(self, key, tree) -> None:
        n = self._out_bytes.get(key)
        if n is None:
            n = self._out_bytes[key] = nbytes(tree)
        COUNTS["copy_out_bytes"] += n


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------


def kernel_wrappers() -> list:
    """The kernel wrappers whose ``launches`` dicts count launches (and K1's
    counts by layout and of its refresh)."""
    return list(named_kernel_wrappers().values())


def named_kernel_wrappers() -> dict:
    """:func:`kernel_wrappers` by name."""
    from ergodic_exploration_tpu_torch.ops.edt_kernel import E
    from ergodic_exploration_tpu_torch.ops.gmm_kernel import K2
    from ergodic_exploration_tpu_torch.ops.mi_dense_kernel import M
    from ergodic_exploration_tpu_torch.ops.mi_kernel import K3
    from ergodic_exploration_tpu_torch.ops.reveal_kernel import R
    from ergodic_exploration_tpu_torch.ops.solve_kernel import K1
    from ergodic_exploration_tpu_torch.ops.tick_glue import G

    return {"K1": K1, "K1.forms": K1.forms, "K1.refresh": K1.refreshes, "K2": K2, "K3": K3,
            "G": G, "R": R, "E": E, "M": M}


def count_captured(fn: Callable, wrappers: Sequence):
    """Run ``fn`` (a capture) and return (its result, the launches it
    counted: one {variant: n} per wrapper). The wrappers' counts are left
    as they were before, since a capture launches nothing. A wrapper's
    ``launches`` dict is read at each use: ``reset_launches`` rebinds it."""
    before = [dict(w.launches) for w in wrappers]
    try:
        out = fn()
        after = [dict(w.launches) for w in wrappers]
    finally:
        for w, b in zip(wrappers, before):
            w.launches.clear()
            w.launches.update(b)
    delta = [{v: n - b.get(v, 0) for v, n in a.items() if n != b.get(v, 0)}
             for a, b in zip(after, before)]
    return out, delta


def add_launches(delta: Sequence[dict], wrappers: Sequence) -> None:
    """Add one replay's launches (``count_captured``'s delta) to the counts."""
    for w, d in zip(wrappers, delta):
        for v, n in d.items():
            w.launches[v] = w.launches.get(v, 0) + n


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

class Graph:
    """``fn`` captured as a CUDA graph on ``device`` (see the module
    docstring). ``capture_s`` is the time the capture and instantiation took
    (the warm-up excluded); ``launches`` the kernel launches of one replay
    per wrapper."""

    def __init__(self, fn: Callable, device, wrappers: Optional[Sequence] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.wrappers = kernel_wrappers() if wrappers is None else list(wrappers)
        self.graph = None
        self.outputs = None
        self.launches = None
        self.capture_s = 0.0

    def __call__(self):
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        add_launches(self.launches, self.wrappers)
        return self.outputs

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)  # the warm-up's and the capture's
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self.fn()
        cur.wait_stream(side)
        for t in leaves(warm):  # consumed on the caller's stream
            t.record_stream(cur)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=side):
                return self.fn()

        self.outputs, self.launches = count_captured(capture, self.wrappers)
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.fn = graph, None  # the function is not needed again
        return warm


def _captured_s(entry: Static) -> float:
    return sum(getattr(g, "capture_s", 0.0) for g in entry.graphs.values())


class GraphCache:
    """At most ``maxsize`` :class:`Static` entries, the least recently used
    evicted first (its buffers and graphs are freed with it)."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries = OrderedDict()
        self._evicted_s = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing every graph this cache has held."""
        return self._evicted_s + sum(_captured_s(e) for e in self._entries.values())

    @spanned("ee.graph.lookup")
    def entry(self, key: tuple, inputs) -> Static:
        """The entry of ``key`` and the :func:`signature` of ``inputs``,
        made over ``inputs`` on a miss (the caller loads them:
        :meth:`Static.load`)."""
        key = key + (signature(inputs),)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = Static(inputs)
            while len(self._entries) > self.maxsize:
                self._evicted_s += _captured_s(self._entries.popitem(last=False)[1])
        self._entries.move_to_end(key)
        return entry
