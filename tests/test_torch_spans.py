"""The engine's spans and counters (``utils/profiling.py``), on the CPU at
small size, each of the five entry points sent down its graph route with
``tests/torch_graph_helpers.py``'s stand-in for the capture. Checked:

(a) with no profiler recording, no span is entered (the profiler's record
    functions are made to raise), and the torch-private record function
    the spans use is there under this torch;
(b) under ``torch.profiler`` (CPU), each call's ``ee.*`` spans form the tree
    the entry point promises, in order: ``ee.graph.capture`` on the first
    call of a graph and ``ee.graph.replay`` afterwards; no ``ee.*`` span
    lies under a capture or a replay, and none outside an entry span;
(c) the counters over two chained ``replan_refresh`` calls: the first makes
    the graph and the lattice operands, the second neither, copies in only
    the poses and twists, and copies out the state, u and diagnostics;
(d) ``chip_spans.py``'s rehearsal on the CPU (a benchmark cell's traced
    window at 4 scenarios): its spans and counters are read and every idle
    gap is named.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops.integrator import rollout
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import graphs, profiling
from torch_graph_helpers import StandIn

torch.set_num_threads(1)
S, CELLS, RES = 4, 24, 0.05
SIDE = CELLS * RES
OPTS = dict(num_basis=5, horizon=8, buffer_capacity=32, buffer_batch=8, grid_samples=(12, 12),
            use_fused_solve=True, shared_maps=True, shared_history_draw=True)
ENTRIES = ("ee.replan", "ee.replan_refresh", "ee.replan_refresh_mi", "ee.explore",
           "ee.explore_mapping_fused")
LOOKUP, COPY_IN, COPY_OUT = "ee.graph.lookup", "ee.graph.copy_in", "ee.graph.copy_out"
CAPTURE, REPLAY = "ee.graph.capture", "ee.graph.replay"


class Case:
    """An engine on the graph route, one walled map shared by S scenarios,
    poses clear of the wall, a GMM, beliefs and the truth map."""

    def __init__(self, seed=3):
        rng = np.random.default_rng(seed)
        eng = self.eng = Engine(default_config("cart").replace(**OPTS), device="cpu")
        eng._on_graphs = lambda collective=False: True
        eng._make_graph = StandIn
        eng.GRAPH_BLOCK = 2  # explore's blocks of 2 ticks: a short call still has a tail
        data = np.zeros((S, CELLS, CELLS), np.float32)
        data[:, 12:14, 4:20] = 1.0
        x0 = np.concatenate([rng.uniform(0.2, 1.0, (S, 1)), np.full((S, 1), 0.15),
                             rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
        self.truth = GridMap(torch.from_numpy(data), torch.zeros((S, 2)), torch.full((S,), RES))
        self.world = eng.prepare_world(self.truth)
        self.domain = Domain.create(0.0, 0.0, SIDE, SIDE)
        self.gmm = GaussianMixture.create(
            rng.uniform(0.2, 1.0, (S, 2, 2)).astype(np.float32),
            np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
            np.ones((S, 2), np.float32))
        self.phik = eng.phik_from_gmm(self.gmm, self.domain, self.world)
        beliefs = np.full((S, CELLS, CELLS), -1.0, np.float32)
        beliefs[:, :, :CELLS // 2] = 0.0
        beliefs[:, 12:14, 4:12] = 1.0
        self.beliefs = self.truth._replace(data=torch.from_numpy(beliefs))
        self.sc = eng.init_scenarios(x0)

    def call(self, entry):
        """One call of the entry point whose span is ``entry``, from the
        initial scenarios."""
        eng, sc = self.eng, self.sc
        return {
            "ee.replan": lambda: eng.replan(sc, self.phik, self.world),
            "ee.replan_refresh": lambda: eng.replan_refresh(sc, self.gmm, self.domain,
                                                            self.world),
            "ee.replan_refresh_mi": lambda: eng.replan_refresh_mi(
                sc, self.beliefs, self.world, 2, domain=self.domain, use_mi_kernel=True),
            "ee.explore": lambda: eng.explore(sc, self.phik, self.world, eng.GRAPH_BLOCK + 1),
            "ee.explore_mapping_fused": lambda: eng.explore_mapping_fused(
                sc, self.truth, 2, refresh_every=1, sensor_range=0.4),
        }[entry]()


def _children(first: bool) -> dict:
    """entry span -> the names of its child spans, in order, on a graph's
    first call (``first``) or a later one."""
    g = CAPTURE if first else REPLAY
    tick = [LOOKUP, COPY_IN, g, COPY_OUT]
    return {"ee.replan": tick, "ee.replan_refresh": tick, "ee.replan_refresh_mi": tick,
            # a block of GRAPH_BLOCK ticks, a 1-tick tail, the final state
            "ee.explore": [LOOKUP, COPY_IN, g, COPY_OUT, g, COPY_OUT, COPY_OUT],
            # two refreshes of one graph, the final state and beliefs
            "ee.explore_mapping_fused": [LOOKUP, COPY_IN, g, COPY_OUT, REPLAY, COPY_OUT,
                                         COPY_OUT]}


def _span_tree(prof) -> list:
    """[(root span, [its children's names])] of the ``ee.*`` spans the
    profiler recorded, in order of start; checks that none lies under a
    capture or replay and that each lies in an entry span."""
    spans = sorted((e for e in prof.events() if e.name.startswith("ee.")),
                   key=lambda e: e.time_range.start)
    roots = []
    for e in spans:
        above, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("ee."):
                above.append(p.name)
            p = p.cpu_parent
        assert not {CAPTURE, REPLAY} & set(above), (e.name, above)
        if above:
            assert above[-1] in ENTRIES and len(above) == 1, (e.name, above)
        else:
            assert e.name in ENTRIES, e.name
            roots.append(e)
    return [(r.name, [c.name for c in spans if c.cpu_parent is not None
                      and c.cpu_parent.id == r.id]) for r in roots]


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_span_is_entered_without_a_profiler(monkeypatch, entry):
    """(a) A capture and a replay with the profiler's record functions made
    to raise."""
    case = Case()

    def refused(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_span", refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    for _ in range(2):
        case.call(entry)


def test_the_spans_record_function_resolves_under_this_torch():
    """(a) The spans record with a torch-private class, resolved at import:
    it is there, and a torch without it fails the import by name."""
    assert profiling.record_span is torch._C._profiler._RecordFunctionFast
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(torch._C._profiler, "_RecordFunctionFast")
        with pytest.raises(ImportError, match="_RecordFunctionFast"):
            profiling._record_function_fast()


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_entry_call_yields_its_span_tree(entry):
    """(b) Two calls under one profiler: the first captures, the second
    replays."""
    case = Case()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        case.call(entry)
        case.call(entry)
    assert _span_tree(prof) == [(entry, _children(True)[entry]),
                                (entry, _children(False)[entry])]


def test_counters_over_two_chained_replan_refresh_calls():
    """(c) The second call's copy-in is the poses and twists alone (its
    state is what the first call's copy-out left in the static buffers)."""
    case = Case()
    eng, sc = case.eng, case.sc
    seen = []
    for _ in range(2):
        before = profiling.counters()
        out = eng.replan_refresh(sc, case.gmm, case.domain, case.world)
        after = profiling.counters()
        seen.append(({k: after[k] - before[k] for k in after}, sc, out))
        x = rollout(eng.model, sc.x, out[1][:, None, :], eng.config.dt)[:, -1]
        sc = out[0]._replace(x=x, vb=eng.model.twist(out[1]))
    (first, sc1, out1), (second, sc2, out2) = seen
    assert (first["graphs_made"], second["graphs_made"]) == (1, 0)
    assert (first["operand_builds"], second["operand_builds"]) == (1, 0)
    (entry,) = eng._tick_graphs._entries.values()
    assert first["copy_in_bytes"] == graphs.nbytes(entry.buffers)
    assert second["copy_in_bytes"] == graphs.nbytes((sc2.x, sc2.vb)) > 0
    for d, out in ((first, out1), (second, out2)):
        assert d["copy_out_bytes"] == graphs.nbytes((out[0].state, out[1], out[2])) > 0
        assert d["libraries_loaded"] == 0  # no kernel library on the CPU
        assert all(v == 0 for k, v in d.items() if k.startswith("launches."))


def test_chip_spans_rehearses_a_traced_window_on_the_cpu():
    """(d) On the CPU the engine runs its eager functions: the entry span
    holds the whole call, and no graph is made or copied."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_spans.py"), "--workload",
                          "cart_gmm_replan", "--seed", "3000000017", "--seconds", "0.3",
                          "--trace", "1", "--cpu"], capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["ticks"] > 0
    prog = got["program"]
    assert prog["entry_self_ms"] > 0 and prog["replay_ms"] == prog["copy_out_ms"] == 0
    assert prog["rebuilds_in_window"] == 0 and prog["copy_in_kb_per_tick"] == 0
    assert got["idle_named_s"] == pytest.approx(got["idle_s"], rel=1e-6)
