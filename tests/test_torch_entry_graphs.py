"""The single-tick entry points and the node's step as CUDA graphs, on the
CPU at small size.

On the card ``Engine.replan``, ``replan_refresh`` and ``replan_refresh_mi``
replay a 1-tick graph of their eager function (``Engine._graph_tick``) and
``ExplorationNode.step`` replays a graph of its tick. Here the engine is
sent down that route with ``tests/torch_graph_helpers.py``'s stand-in for
the capture (its later calls refuse host copies and device waits, as a
capture does). Checked:

(a) graph route against eager route, bit for bit over 5 chained ticks with a
    pose advance between them: ``replan`` (cart eager, cart fused, omni),
    ``replan_refresh`` (the refresh inside K1, and K2 ahead of K1) and
    ``replan_refresh_mi`` (K3's plain version, the dense path, the
    separable path);
(b) what a call returns is not changed by the calls after it;
(c) the copy-in: a leaf changed in place is copied again, an unchanged leaf
    is not (counted with a spy on ``utils.graphs.copy_leaves``), and the
    tick after the change still equals the eager one;
(d) a CUDA engine and a CUDA node take the graph route and never call the
    eager function themselves; a populated ``sample`` mesh dim keeps the
    refresh ticks eager;
(e) the single-tick cache never evicts ``explore``'s entries; the bench
    twin's three timed functions take the graph route and reach the state
    their ``eager=True`` runs reach, bit for bit;
(f) the node's graph route equals its eager step over 30 ticks with a map
    update of the same shape (no recapture) and one of another (a new
    graph), pipelined and not;
(g) the graph route of ``replan_refresh`` (the refresh inside K1) and
    ``replan_refresh_mi`` (the dense path) against the JAX engine for 3
    ticks, within the parity budgets of tests/test_solve_kernel.py: controls
    and U atol 5e-5, the metric rtol 1e-5, codes and DWA flags equal. The MI
    tick through K3 is held to the JAX package's Pallas kernel for one tick
    by tests/test_torch_mapping.py; over 3 ticks its target, which the JAX
    package holds to rtol 2e-4 against the dense path, moved a U element by
    1.2e-4 on these inputs (tick 3; 3.5e-5 at tick 1, 2.4e-5 on the dense
    path), so the 3-tick check takes the dense path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu.ops.integrator import rollout as j_rollout
from ergodic_exploration_tpu_torch import bench
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.node import ExplorationNode
from ergodic_exploration_tpu_torch.ops.integrator import rollout
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.parallel import map_tree
from ergodic_exploration_tpu_torch.utils import graphs
from torch_graph_helpers import StandIn

torch.set_num_threads(1)
S, CELLS, RES = 4, 24, 0.05
SIDE = CELLS * RES
OPTS = dict(num_basis=5, horizon=8, buffer_capacity=32, buffer_batch=8, grid_samples=(12, 12),
            shared_maps=False, shared_history_draw=False)
SHARED = dict(shared_maps=True, shared_history_draw=True)
# id -> (entry point, model, configuration overrides, MI arguments)
CASES = {
    "replan-cart-eager": ("replan", "cart", dict(use_fused_solve=False), None),
    "replan-cart-fused": ("replan", "cart", dict(use_fused_solve=True), None),
    "replan-omni": ("replan", "omni", dict(use_fused_solve=False), None),
    "refresh-in-k1": ("refresh", "cart", dict(use_fused_solve=True, **SHARED), None),
    "refresh-k2": ("refresh", "cart", dict(use_fused_solve=True), None),
    "mi-k3": ("mi", "cart", dict(use_fused_solve=True), dict(shared=True, use_mi_kernel=True)),
    "mi-dense": ("mi", "cart", dict(use_fused_solve=False), dict(shared=True, use_mi_kernel=False)),
    "mi-separable": ("mi", "cart", dict(use_fused_solve=True), dict(shared=False,
                                                                    use_mi_kernel=True)),
}


class Case:
    """Maps (one shared map, or a wall at a per-scenario row), poses clear
    of the walls, a two-component GMM and beliefs per scenario, made from a
    seed; the world, phi_k and the initial scenarios on ``eng``."""

    def __init__(self, eng, seed=3):
        rng = np.random.default_rng(seed)
        data = np.zeros((S, CELLS, CELLS), np.float32)
        rows = np.full(S, 12) if eng.config.shared_maps else rng.integers(4, 18, S)
        for s in range(S):
            data[s, rows[s]:rows[s] + 2, 4:20] = 1.0
        self.x0 = np.concatenate([rng.uniform(0.2, 1.0, (S, 1)), np.full((S, 1), 0.15),
                                  rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
        grids = GridMap(torch.from_numpy(data), torch.zeros((S, 2)), torch.full((S,), RES))
        self.world = eng.prepare_world(grids)
        self.domain = Domain.create(0.0, 0.0, SIDE, SIDE)
        self.gmm = GaussianMixture.create(
            rng.uniform(0.2, 1.0, (S, 2, 2)).astype(np.float32),
            np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
            np.ones((S, 2), np.float32))
        self.phik = eng.phik_from_gmm(self.gmm, self.domain, self.world)
        beliefs = np.full((S, CELLS, CELLS), -1.0, np.float32)
        beliefs[:, :, :CELLS // 2] = 0.0
        beliefs[:, 12:14, 4:12] = 1.0
        for s in range(S):
            r0 = rng.integers(0, CELLS - 6)
            beliefs[s, r0:r0 + 6, 12:18] = rng.uniform(0.0, 1.0, (6, 6))
        self.beliefs = grids._replace(data=torch.from_numpy(beliefs))
        self.sc = eng.init_scenarios(self.x0)


def _engine(model, overrides, graph: bool):
    """An engine on the CPU; with ``graph`` its single-tick entry points
    take the graph route with the stand-in for the capture."""
    eng = Engine(default_config(model).replace(**{**OPTS, **overrides}), device="cpu")
    if graph:
        eng._on_graphs = lambda collective=False: True
        eng._make_graph = StandIn
    return eng


def _tick(kind, eng, case, mi=None):
    """The public entry point ``kind`` of ``eng`` on ``case``: sc -> (sc, u, diag)."""
    if kind == "replan":
        return lambda sc: eng.replan(sc, case.phik, case.world)
    if kind == "refresh":
        return lambda sc: eng.replan_refresh(sc, case.gmm, case.domain, case.world)
    domain = case.domain if mi["shared"] else None
    return lambda sc: eng.replan_refresh_mi(sc, case.beliefs, case.world, 2, domain=domain,
                                            use_mi_kernel=mi["use_mi_kernel"])


def _advance(eng, sc, u):
    x = rollout(eng.model, sc.x, u[:, None, :], eng.config.dt)[:, -1]
    return sc._replace(x=x, vb=eng.model.twist(u))


def _assert_same(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def _pair(name):
    """(graph engine, its case, its tick; eager engine, its case, its tick)."""
    kind, model, overrides, mi = CASES[name]
    out = []
    for graph in (True, False):
        eng = _engine(model, overrides, graph)
        case = Case(eng)
        out += [eng, case, _tick(kind, eng, case, mi)]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_graph_route_equals_eager_bit_for_bit(name):
    """(a) and (b): 5 chained ticks, graph route against eager route; the
    outputs of every tick are held unchanged to the end."""
    g_eng, g_case, g_tick, e_eng, e_case, e_tick = _pair(name)
    sc_g, sc_e = g_case.sc, e_case.sc
    kept = []
    for _ in range(5):
        got, ref = g_tick(sc_g), e_tick(sc_e)
        _assert_same(got, ref)
        kept.append((got, map_tree(torch.clone, got)))
        sc_g, sc_e = _advance(g_eng, got[0], got[1]), _advance(e_eng, ref[0], ref[1])
    for got, copy in kept:  # (b) no later call wrote into an earlier call's outputs
        _assert_same(got, copy)
    (entry,) = g_eng._tick_graphs._entries.values()
    assert [g.calls for g in entry.graphs.values()] == [5]


def _named(tree, prefix=""):
    """[(dotted name, leaf)] of a tree of NamedTuples and tuples."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        keys = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        return [x for k, v in zip(keys, tree) for x in _named(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def test_copy_in_copies_only_what_changed(monkeypatch):
    """(c) On replan_refresh_mi with K3's plain version: the first call
    copies every leaf in; a chained call with the same inputs copies none
    (the state it returned is what the static state holds, the poses are the
    caller's own); an in-place change to the beliefs or to the world is
    copied, and only it; new pose tensors are copied, and only they. Each
    tick equals the eager engine's bit for bit."""
    g_eng, g_case, g_tick, e_eng, e_case, e_tick = _pair("mi-k3")
    copied = []
    real = graphs.copy_leaves

    def spy(dsts, srcs):
        copied.append(list(dsts))
        real(dsts, srcs)

    monkeypatch.setattr(graphs, "copy_leaves", spy)
    sc = {"g": g_case.sc, "e": e_case.sc}

    def tick():
        """One tick of both; the names of the static leaves it copied in."""
        copied.clear()
        got, ref = g_tick(sc["g"]), e_tick(sc["e"])
        _assert_same(got, ref)
        sc["g"], sc["e"] = got[0], ref[0]
        (entry,) = g_eng._tick_graphs._entries.values()
        names = {id(t): k for k, t in _named(entry.buffers)}
        return sorted(names[id(t)] for call in copied for t in call if id(t) in names), entry

    first, entry = tick()
    assert first == sorted(k for k, _ in _named(entry.buffers))
    assert "4.cxA" in first  # K3's operands are an input of the graph
    assert tick()[0] == []
    for c in (g_case, e_case):
        c.beliefs.data[:, 3, 3] = 0.25
    assert tick()[0] == ["1.data"]
    for c in (g_case, e_case):
        c.world.dist.dist[:, 20:, 20:] += 0.01
    assert tick()[0] == ["2.dist.dist"]
    assert tick()[0] == []
    sc["g"] = sc["g"]._replace(x=sc["g"].x + 0.01, vb=sc["g"].vb * 0.5)
    sc["e"] = sc["e"]._replace(x=sc["e"].x + 0.01, vb=sc["e"].vb * 0.5)
    assert tick()[0] == ["0.vb", "0.x"]


def test_static_load_follows_versions():
    """(c) ``Static.load`` on its own: a view written in place, a new
    tensor of the same values, an inference tensor (no version: copied on
    every load), and ``holds`` after a graph wrote a buffer."""
    a, b = torch.arange(6.0), torch.zeros(2, dtype=torch.int32)
    st = graphs.Static((a, b))
    assert st.load((a, b)) == 2 and st.load((a, b)) == 0
    a[2:4].mul_(2.0)  # through a view: the version is shared
    assert st.load((a, b)) == 1 and torch.equal(st.buffers[0], a)
    assert st.load((a.clone(), b)) == 1
    with torch.inference_mode():
        c = torch.ones(2, dtype=torch.int32)
    assert st.load((a, c)) == 2 and st.load((a, c)) == 1
    st.buffers[1].add_(1)  # a graph writes the buffer
    st.holds(st.buffers[1])
    assert st.load((a, b)) == 1 and torch.equal(st.buffers[1], b)
    out = graphs.clone(st.buffers[1])
    st.holds(st.buffers[1], out)
    assert st.load((a, out)) == 0
    assert st.load((st.buffers[0], out)) == 0  # a buffer passed as its own source


def test_cuda_engine_and_node_take_the_graph_route(monkeypatch):
    """(d) The engine is only labelled CUDA: each entry point goes to
    ``_graph_tick`` and never calls its eager function; on a mesh with a
    populated sample dim the refresh ticks are eager and ``replan`` is not.
    The node (also only labelled) replays its graph."""
    eng = _engine("cart", dict(use_fused_solve=True), graph=False)
    case = Case(eng)
    seen = []
    monkeypatch.setattr(eng, "_graph_tick", lambda name, *a: seen.append(name) or "graph")
    for fn in ("_replan_fn", "_refresh_and_replan_fn", "_refresh_mi_and_replan_fn"):
        monkeypatch.setattr(eng, fn, lambda *a, fn=fn: seen.append(fn) or "eager")
    monkeypatch.setattr(eng, "_here", lambda t: t)
    monkeypatch.setattr(eng, "_grids_here", lambda g: g)
    eng.device = torch.device("cuda", 0)
    for mi in (CASES["mi-k3"][3], CASES["mi-separable"][3]):
        assert [_tick(k, eng, case, mi)(case.sc) for k in ("replan", "refresh", "mi")
                ] == ["graph"] * 3
    monkeypatch.setattr(eng, "_sample_ranks", lambda: 2)
    assert [_tick(k, eng, case, CASES["mi-k3"][3])(case.sc) for k in ("replan", "refresh", "mi")
            ] == ["graph", "eager", "eager"]
    assert seen == ["replan", "replan_refresh", "replan_refresh_mi"] * 2 + [
        "replan", "_refresh_and_replan_fn", "_refresh_mi_and_replan_fn"]

    node = _node(pipeline=False)
    node.step()  # on the CPU: the map and target, the eager tick
    node.device = torch.device("cuda", 0)
    monkeypatch.setattr(node, "_eager_tick", None)
    monkeypatch.setattr(node, "_graph_tick", lambda: torch.zeros(10))
    twist, diag = node.step()
    assert np.array_equal(twist, np.zeros(3)) and node.ticks == 2


def test_tick_cache_never_evicts_explore_entries():
    """(e) Ten graphs of replan_refresh_mi (one per sensor radius) fill the
    single-tick cache past its size; explore's entry stays."""
    eng = _engine("cart", dict(use_fused_solve=True), graph=True)
    case = Case(eng)
    eng._explore_graphs(case.sc, case.phik, case.world, 1, StandIn)
    (explore_entry,) = eng._graphs._entries.values()
    for r in range(10):
        eng.replan_refresh_mi(case.sc, case.beliefs, case.world, r, domain=case.domain,
                              use_mi_kernel=True)
    assert len(eng._tick_graphs) == eng._tick_graphs.maxsize == 8
    assert list(eng._graphs._entries.values()) == [explore_entry]


@pytest.mark.parametrize("timed", ["throughput", "mi", "latency"])
def test_bench_times_the_graph_route(monkeypatch, timed):
    """(e) bench.py's twin at S = 2 on the CPU, every engine sent down the
    graph route: each timed function replays its entry point's graph and
    ends where its eager run (``eager=True``) ends."""
    monkeypatch.setattr(Engine, "_on_graphs", lambda self, collective=False: True)
    monkeypatch.setattr(Engine, "_make_graph", lambda self, fn: StandIn(fn))
    run = {"throughput": lambda **kw: bench.bench_throughput(S=2, iters=2, **kw),
           "mi": lambda **kw: bench.bench_throughput_mi(S=2, iters=2, **kw),
           "latency": lambda **kw: bench.bench_latency(reps=2, group=1, chain=2, **kw)}[timed]
    got, ref = {}, {}
    run(device="cpu", reached=got)
    run(device="cpu", reached=ref, eager=True)
    _assert_same(got["sc"], ref["sc"])
    (entry,) = got["engine"]._tick_graphs._entries.values()
    assert entry.graphs[1].calls > 1 and len(ref["engine"]._tick_graphs) == 0


# --- (f) the node ------------------------------------------------------------

NODE_OPTS = dict(num_basis=6, horizon=10, buffer_capacity=64, buffer_batch=16,
                 grid_samples=(20, 20), use_fused_solve=True)


def _node(pipeline, fused=True):
    cfg = default_config("cart").replace(**{**NODE_OPTS, "use_fused_solve": fused})
    gmm = GaussianMixture.create(np.array([[0.6, 1.5], [1.5, 1.5]], np.float32),
                                 np.tile(0.1 * np.eye(2, dtype=np.float32)[None], (2, 1, 1)))
    node = ExplorationNode(cfg, target=gmm, pipeline=pipeline, device="cpu")
    node.on_map(_node_map(0), resolution=RES)
    return node


def _node_map(i, cells=40):
    m = np.zeros((cells, cells), np.int8)
    m[18:20, 8:32] = 100
    m[28:30 + i, 22:26] = 100
    return m


@pytest.mark.parametrize("fused", [True, False], ids=["k1", "eager-step"])
@pytest.mark.parametrize("pipeline", [False, True], ids=["direct", "pipelined"])
def test_node_graph_route_equals_its_eager_step(pipeline, fused):
    """(f) 30 ticks on one odometry stream: at tick 12 a map update of the
    same shape (copied into the node's buffers, the graph kept), at tick 24
    one of another shape (a new graph); every tick's twist and diagnostics
    and the final state equal bit for bit."""
    g, e = _node(pipeline, fused), _node(pipeline, fused)
    made = []

    def make(fn):
        made.append(StandIn(fn))
        return made[-1]

    for i in range(30):
        if i in (12, 24):
            m = _node_map(1) if i == 12 else np.pad(_node_map(1), ((0, 4), (0, 4)))
            g.on_map(m, resolution=RES)
            e.on_map(m, resolution=RES)
        pose = [0.6 + 0.02 * i, 0.5 + 0.01 * i, 0.3]
        for n in (g, e):
            n.on_odom(pose, [0.05, 0.0, 0.1])
        got = g._step(lambda: g._graph_tick(make))
        ref = e._step(e._eager_tick)
        if got[1] is None:
            assert ref[1] is None and i == 0 and pipeline
            continue
        assert np.array_equal(got[0], ref[0]) and got[1] == ref[1]
    if pipeline:
        (tw_g, d_g), (tw_e, d_e) = g.flush(), e.flush()
        assert np.array_equal(tw_g, tw_e) and d_g == d_e
    _assert_same(g.state, e.state)
    assert [m.calls for m in made] == [24, 6]


# --- (g) against the JAX engine ----------------------------------------------

JS = 8
J_OPTS = dict(num_basis=6, buffer_capacity=64, grid_samples=(23, 23), **SHARED)


def _j_inputs(seed=5):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.3, 1.7, (JS, 2)), rng.uniform(-3, 3, (JS, 1))],
                        axis=1).astype(np.float32)
    wall = np.zeros((40, 40), np.float32)
    wall[10:14, 5:15] = 1.0
    beliefs = np.full((JS, 40, 40), -1.0, np.float32)
    beliefs[:, :, :20] = 0.0
    beliefs[:, 10:14, 5:15] = 1.0
    for s in range(JS):
        r0 = rng.integers(0, 34)
        beliefs[s, r0:r0 + 6, 20:28] = rng.uniform(0.0, 1.0, (6, 8))
    gmm = (rng.uniform(0.5, 1.5, (JS, 2, 2)).astype(np.float32),
           np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None], (JS, 2, 1, 1)),
           np.ones((JS, 2), np.float32))
    return x0, wall, beliefs, gmm


def _j_grids(data, lib):
    if lib == "jax":
        return JGridMap(jnp.asarray(data), jnp.zeros((JS, 2)), jnp.full((JS,), RES))
    return GridMap(torch.from_numpy(np.ascontiguousarray(data)), torch.zeros((JS, 2)),
                   torch.full((JS,), RES))


@pytest.mark.parametrize("entry", ["refresh", "mi"])
def test_graph_route_matches_jax(entry):
    """(g) 3 ticks with a pose advance, the port's graph route (K1 with the
    refresh inside; the dense MI target then K1) against the JAX engine's
    vmapped path."""
    x0, wall, beliefs, gmm = _j_inputs()
    walls = np.broadcast_to(wall, (JS, 40, 40))
    je = JEngine(j_default_config("cart").replace(use_fused_solve=False, use_pallas=False,
                                                  **J_OPTS))
    jw, jd = je.prepare_world(_j_grids(walls, "jax")), JDomain.create(0.0, 0.0, 2.0, 2.0)
    jg, jb = jtarget.GaussianMixture.create(*gmm), _j_grids(beliefs, "jax")
    m, dt = je.controller.model, je.config.dt
    j_adv = jax.jit(lambda sc, u: sc._replace(
        x=jax.vmap(lambda x, uu: j_rollout(m, x, uu[None, :], dt)[-1])(sc.x, u),
        vb=m.twist(u)))
    te = Engine(default_config("cart").replace(use_fused_solve=True, **J_OPTS), device="cpu")
    te._on_graphs = lambda collective=False: True
    te._make_graph = StandIn
    tw, td = te.prepare_world(_j_grids(walls, "torch")), Domain.create(0.0, 0.0, 2.0, 2.0)
    tg, tb = GaussianMixture.create(*gmm), _j_grids(beliefs, "torch")
    jsc, tsc = je.init_scenarios(x0), te.init_scenarios(x0)
    for _ in range(3):
        if entry == "refresh":
            jsc, ju, jdg = je.replan_refresh(jsc, jg, jd, jw)
            tsc, tu, tdg = te.replan_refresh(tsc, tg, td, tw)
        else:
            jsc, ju, jdg = je.replan_refresh_mi(jsc, jb, jw, 3, domain=jd)
            tsc, tu, tdg = te.replan_refresh_mi(tsc, tb, tw, 3, domain=td)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=5e-5)
        np.testing.assert_allclose(tsc.state.U.numpy(), np.asarray(jsc.state.U), atol=5e-5)
        np.testing.assert_allclose(tdg.ergodic_metric.numpy(), np.asarray(jdg.ergodic_metric),
                                   rtol=1e-5, atol=1e-7)
        for f in ("collision_code", "dwa_active", "dwa_feasible"):
            np.testing.assert_array_equal(getattr(tdg, f).numpy(), np.asarray(getattr(jdg, f)))
        jsc = j_adv(jsc, ju)
        tsc = _advance(te, tsc, tu)
    (entry_,) = te._tick_graphs._entries.values()
    assert [g.calls for g in entry_.graphs.values()] == [3]
