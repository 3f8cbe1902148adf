"""The closed loops as CUDA graphs, on the CPU at small size.

A CUDA graph cannot be captured here, so the engine's graph structure
(``Engine._explore_graphs``, ``Engine._mapping_graphs``) is driven with a
stand-in for ``utils.graphs.Graph``: its first call runs the function as the
warm-up does, every later call runs it under a dispatch mode that refuses
the operations which copy from host memory or wait for the device (what a
capture would refuse), and, as a replay does, writes into the outputs of its
first later call. Checked here:

(a) the functions that get captured (a block of ``explore`` ticks, one
    refresh of ``explore_mapping_fused``), cart and omni, fused and eager,
    neither copy from the host nor wait for the device;
(b) the block structure (copy-in, blocks of ``GRAPH_BLOCK`` ticks, the
    1-tick tail, copy-out) equals ``_explore_loop`` bit for bit, at
    n_ticks = 1 and at a length that is not a multiple of the block, and the
    mapping graph equals ``_explore_mapping_fused_loop``;
(c) the launch bookkeeping of capture and replay, with a stub wrapper.
"""

import contextlib

import numpy as np
import pytest
import torch

from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.parallel import map_tree
from ergodic_exploration_tpu_torch.utils import graphs
from torch_graph_helpers import StandIn

torch.set_num_threads(1)
S, CELLS = 4, 24
OPTS = dict(num_basis=5, horizon=8, buffer_capacity=32, buffer_batch=8, grid_samples=(12, 12),
            shared_maps=False, shared_history_draw=False)
CASES = [(m, f) for m in ("cart", "omni") for f in (True, False)]


def _id(case):
    return f"{case[0]}-{'fused' if case[1] else 'eager'}"


def _case(model, fused, seed=3):
    """A walled 1.2 m map per scenario (the wall at a per-scenario row),
    poses clear of it, a two-component GMM each."""
    rng = np.random.default_rng(seed)
    data = np.zeros((S, CELLS, CELLS), np.float32)
    for s in range(S):
        r = rng.integers(4, 18)
        data[s, r:r + 2, 4:20] = 1.0
    x0 = np.concatenate([rng.uniform(0.2, 1.0, (S, 1)), np.full((S, 1), 0.15),
                         rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
    cfg = default_config(model).replace(use_fused_solve=fused, **OPTS)
    eng = Engine(cfg, device="cpu")
    grids = GridMap(torch.from_numpy(data), torch.zeros((S, 2)), torch.full((S,), 0.05))
    world = eng.prepare_world(grids)
    gmm = GaussianMixture.create(rng.uniform(0.2, 1.0, (S, 2, 2)).astype(np.float32),
                                 np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None],
                                         (S, 2, 1, 1)),
                                 np.ones((S, 2), np.float32))
    phik = eng.phik_from_gmm(gmm, Domain.create(0.0, 0.0, 1.2, 1.2), world)
    return eng, eng.init_scenarios(x0), phik, world, grids


def _assert_same(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_captured_ticks_neither_copy_from_the_host_nor_wait(case):
    """(a) Two blocks and three tail ticks: the second block and the later
    tail ticks run under NoSync, as their capture would."""
    eng, sc, phik, world, _ = _case(*case)
    made = []

    def make(fn):
        made.append(StandIn(fn))
        return made[-1]

    eng._explore_graphs(sc, phik, world, 2 * eng.GRAPH_BLOCK + 3, make)
    assert sorted(g.calls for g in made) == [2, 3]


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_captured_refresh_neither_copies_from_the_host_nor_waits(model):
    """(a) One refresh of explore_mapping_fused (reveal, MI target, world,
    ticks) under NoSync, in its second and third calls."""
    eng, sc, _, _, truth = _case(model, True)
    made = []

    def make(fn):
        made.append(StandIn(fn))
        return made[-1]

    eng._mapping_graphs(sc, truth, 3, 2, 0.4, 0, make_graph=make)
    assert [g.calls for g in made] == [3]


@pytest.mark.parametrize("n_ticks", [1, 13])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_blocks_equal_the_loop_bit_for_bit(case, n_ticks):
    """(b) Copy-in, blocks, tail and copy-out against the plain loop; then a
    second call from the state the first reached, which reuses the static
    buffers and replays, against the loop from that state. The caller's
    inputs are left as they were."""
    eng, sc, phik, world, _ = _case(*case)
    before = map_tree(torch.clone, (sc, phik, world))
    got = eng._explore_graphs(sc, phik, world, n_ticks, StandIn)
    _assert_same((sc, phik, world), before)
    _assert_same(got, eng._explore_loop(sc, phik, world, n_ticks))
    again = eng._explore_graphs(got.scenarios, phik, world, n_ticks, StandIn)
    _assert_same(again, eng._explore_loop(got.scenarios, phik, world, n_ticks))
    assert len(eng._graphs) == 1


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_mapping_graph_equals_the_loop_bit_for_bit(model):
    """(b) One graph a refresh against the plain refresh loop."""
    eng, sc, _, _, truth = _case(model, model == "cart")
    got = eng._mapping_graphs(sc, truth, 3, 2, 0.4, 0, make_graph=StandIn)
    _assert_same(got, eng._explore_mapping_fused_loop(sc, truth, 3, 2, 0.4, 0))


def test_explore_on_a_cuda_engine_takes_the_graphs(monkeypatch):
    """No fallback: a CUDA engine's closed loops go to the graph structure,
    never to the plain loops (the engine is only labelled CUDA here)."""
    eng, sc, phik, world, truth = _case("cart", True)
    seen = []
    monkeypatch.setattr(eng, "_explore_graphs", lambda *a: seen.append("explore"))
    monkeypatch.setattr(eng, "_mapping_graphs", lambda *a, **k: seen.append("mapping"))
    monkeypatch.setattr(eng, "_ticks", None)  # the loops' body: never reached
    eng.device = torch.device("cuda", 0)
    eng.explore(sc, phik, world, 3)
    eng.explore_mapping_fused(sc, truth, 2)
    assert seen == ["explore", "mapping"]


# --- (c) launch accounting ---------------------------------------------------


class Stub:
    """A kernel wrapper's counting surface."""

    def __init__(self):
        self.reset_launches()

    def reset_launches(self):
        self.launches = {"a": 0, "b": 0}

    def launch(self, variant):
        self.launches[variant] += 1


def test_a_capture_counts_nothing_and_each_replay_adds_its_launches():
    w1, w2 = Stub(), Stub()
    w1.launch("a")

    def body():
        w1.launch("a")
        w1.launch("a")
        w2.launch("b")
        return "captured"

    out, delta = graphs.count_captured(body, [w1, w2])
    assert out == "captured" and delta == [{"a": 2}, {"b": 1}]
    assert w1.launches == {"a": 1, "b": 0} and w2.launches == {"a": 0, "b": 0}
    w1.reset_launches()  # rebinds the dict, as the wrappers do
    for _ in range(3):
        graphs.add_launches(delta, [w1, w2])
    assert w1.launches == {"a": 6, "b": 0} and w2.launches == {"a": 0, "b": 3}


def test_a_failed_capture_raises_and_leaves_the_counts():
    w = Stub()

    def body():
        w.launch("b")
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.count_captured(body, [w])
    assert w.launches == {"a": 0, "b": 0}


def test_graph_counts_the_warm_up_once_and_every_replay(monkeypatch):
    """Graph's own flow with the CUDA calls stubbed: the warm-up's launches
    count, the capture's are taken back, each replay adds them again."""
    w = Stub()
    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    class FakeStream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    calls = []

    def fn():
        calls.append(1)
        w.launch("a")
        w.launch("b")
        return (torch.tensor(len(calls)),)

    g = graphs.Graph(fn, "cpu", wrappers=[w])
    assert g()[0] == 1  # the warm-up's own result
    assert len(calls) == 2 and w.launches == {"a": 1, "b": 1} and g.fn is None
    for _ in range(4):
        assert g()[0] == 2  # the captured outputs
    assert len(replays) == 4 and w.launches == {"a": 5, "b": 5}


def test_the_cache_is_bounded_and_keyed_on_the_signature():
    cache = graphs.GraphCache(maxsize=2)
    a = (torch.zeros(3), None)
    entries = [cache.static(("k", graphs.signature(x)), x)
               for x in (a, (torch.zeros(4), None), (torch.zeros(3), torch.zeros(1)))]
    assert len(cache) == 2 and len({id(e) for e in entries}) == 3
    assert graphs.signature(a) != graphs.signature((torch.zeros(3, dtype=torch.int32), None))
    e = cache.static(("k", graphs.signature(a)), (torch.ones(3), None))
    assert e is not entries[0] and torch.equal(e.buffers[0], torch.ones(3))
    assert cache.static(("k", graphs.signature(a)), (torch.full((3,), 2.0), None)) is e
    assert torch.equal(e.buffers[0], torch.full((3,), 2.0)) and e.buffers[1] is None
