"""The history ring appended in place (``RingBuffer.append_``,
``glue_post(..., ring_in_place=True)``), which the graph bodies use on their
static state, against the copying append every other caller gets.

Checked on the CPU at small size:

(a) ``append_`` writes the same values as ``append``, bit for bit, over
    appends that fill the ring and wrap it, into the ring it was given;
(b) the eager functions (``replan``, ``replan_refresh``, the ``explore``
    loop, ``ErgodicController.step``, the node's eager tick) leave every
    tensor of the caller's state as it was;
(c) the tick bodies with ``ring_in_place=True`` equal the functional ticks
    bit for bit over 10 chained ticks, and each of those ticks is within the
    parity budgets of tests/test_solve_kernel.py (controls and U atol 5e-5,
    the metric rtol 1e-5, codes and DWA flags equal; rings, cursors, counts
    and keys equal) of the JAX package's vmapped step from the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.controller import ControllerState as JState
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.engine import Scenarios as JScenarios
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops.buffer import RingBuffer as JRingBuffer
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.node import ExplorationNode
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import graphs

torch.set_num_threads(2)
S, CELLS, RES, TICKS = 6, 40, 0.05, 10
OPTS = dict(num_basis=5, horizon=8, buffer_capacity=8, buffer_batch=6, grid_samples=(16, 16))
# id -> configuration overrides (the capacity of 8 wraps within the 10 ticks)
CONFIGS = {
    "fused_shared_draw": dict(use_fused_solve=True, shared_maps=True, shared_history_draw=True),
    "fused_per_scenario_draws": dict(use_fused_solve=True, shared_maps=False,
                                     shared_history_draw=False),
    "eager_step": dict(use_fused_solve=False, shared_maps=False, shared_history_draw=False),
}


def _case(overrides, seed=4):
    """(engine on the CPU, fresh scenarios, world, phi_k, GMM, shared domain,
    map data and poses as numpy), made from a seed: a wall across a shared
    map, poses clear of it."""
    eng = Engine(default_config("cart").replace(**{**OPTS, **overrides}), device="cpu")
    rng = np.random.default_rng(seed)
    data = np.zeros((S, CELLS, CELLS), np.float32)
    data[:, 20:22, 6:34] = 1.0
    x0 = np.concatenate([rng.uniform(0.3, 1.7, (S, 1)), rng.uniform(0.3, 0.8, (S, 1)),
                         rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
    world = eng.prepare_world(GridMap(torch.from_numpy(data), torch.zeros((S, 2)),
                                      torch.full((S,), RES)))
    dom = Domain.create(0.0, 0.0, CELLS * RES, CELLS * RES)
    gmm = GaussianMixture.create(rng.uniform(0.4, 1.6, (S, 2, 2)).astype(np.float32),
                                 np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None],
                                         (S, 2, 1, 1)), np.ones((S, 2), np.float32))
    phik = eng.phik_from_gmm(gmm, dom, world)
    return eng, eng.init_scenarios(x0), world, phik, gmm, dom, data, x0


def _equal(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and x.dtype == y.dtype
                                      and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("cap", [5, 8])
def test_append_in_place_matches_append(cap):
    """``append_`` against ``append`` over 2 cap + 3 appends from rings part
    filled, full and empty: the same states, cursors and counts bit for bit,
    written into the ring ``append_`` was given."""
    rng = np.random.default_rng(cap)
    n = 4
    cursor = np.array([0, 3, cap - 1, 1], np.int32)
    count = np.array([0, 3, cap, cap], np.int32)
    ring = RingBuffer(torch.from_numpy(rng.uniform(0, 3, (n, 2, cap)).astype(np.float32)),
                      torch.from_numpy(cursor), torch.from_numpy(count))
    own = ring._replace(states=ring.states.clone())
    states = own.states
    for _ in range(2 * cap + 3):
        p = torch.from_numpy(rng.uniform(0, 3, (n, 3)).astype(np.float32))
        ring, own = ring.append(p), own.append_(p)
        assert own.states is states
        assert _equal(ring, own)
    assert (own.count == cap).all()


@pytest.mark.parametrize("entry", ["replan", "replan_refresh", "explore", "controller_step",
                                   "node_eager_tick"])
def test_eager_calls_keep_the_callers_state(entry):
    """An eager call never changes its caller's state: every tensor of the
    scenarios (or the node's state) handed in holds the same values after
    the call, and the ring it returns is a new tensor."""
    cfg = dict(use_fused_solve=True, shared_maps=True, shared_history_draw=True)
    if entry == "controller_step":
        cfg = CONFIGS["eager_step"]
    eng, sc, world, phik, gmm, dom, data, _ = _case(cfg)
    sc = eng.explore(sc, phik, world, 3).scenarios  # a ring with history
    if entry == "node_eager_tick":
        node = ExplorationNode(eng.config, target=(gmm.means[0].numpy(), gmm.covs[0].numpy(),
                                                   gmm.weights[0].numpy()), device="cpu")
        node.on_map(data[0], 0.0, 0.0, RES)
        node.on_odom(sc.x[0].numpy(), np.zeros(3, np.float32))
        node.step()
        before = node.state
        held = graphs.clone(before)
        node._step(node._eager_tick)
        assert _equal(before, held)
        assert node.state.buffer.states is not before.buffer.states
        return
    held = graphs.clone(sc)
    if entry == "replan":
        out = eng.replan(sc, phik, world)[0].state
    elif entry == "replan_refresh":
        out = eng.replan_refresh(sc, gmm, dom, world)[0].state
    elif entry == "explore":
        out = eng.explore(sc, phik, world, TICKS).scenarios.state
    else:
        out = eng.controller.step(sc.state, sc.x, sc.vb, phik, world)[0]
    assert _equal(sc, held)
    assert out.buffer.states is not sc.state.buffer.states
    assert not torch.equal(out.buffer.states, sc.state.buffer.states)


def _jax_tick(opts, data, phik):
    """f(sc): one vmapped JAX replan from the port's scenarios ``sc``: its
    state, u and diagnostics as numpy."""
    jcfg = j_default_config("cart").replace(use_pallas=False, **{**OPTS, **opts,
                                                                  "use_fused_solve": False})
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.asarray(data), jnp.zeros((S, 2)), jnp.full((S,), RES)))
    jphik = jnp.asarray(phik)

    def tick(sc):
        a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        st = sc.state
        jst = JState(a(st.U), JRingBuffer(*map(a, st.buffer)), a(st.ck_sum), a(st.hist_count),
                     jnp.asarray(st.rng.numpy().astype(np.uint32)))
        jsc, u, dg = je.replan(JScenarios(jst, a(sc.x), a(sc.vb)), jphik, jw)
        return jax.tree.map(np.asarray, (jsc.state, u, dg))

    return tick


@pytest.mark.parametrize("config", list(CONFIGS))
def test_in_place_ticks_match_functional_and_jax(config):
    """The tick body with ``ring_in_place=True`` (on the engine's own copy of
    the state, as a graph's static buffers) against the functional tick over
    TICKS chained ticks: bit for bit, the in-place ring always the same
    tensor; both against the JAX package's vmapped step within the parity
    budgets."""
    eng, sc, world, phik, gmm, dom, data, _ = _case(CONFIGS[config])
    jax_tick = _jax_tick(CONFIGS[config], data, phik.numpy())
    own = graphs.clone(sc)
    ring = own.state.buffer.states
    fun = sc
    for t in range(TICKS):
        st_r, u_r, dg_r = jax_tick(own)
        fun, u_f, dg_f = eng._replan_fn(fun, phik, world)
        own, u_i, dg_i = eng._replan_fn(own, phik, world, ring_in_place=True)
        assert own.state.buffer.states is ring
        assert _equal((fun, u_f, dg_f), (own, u_i, dg_i)), t
        np.testing.assert_allclose(u_i.numpy(), u_r, rtol=0, atol=5e-5)
        np.testing.assert_allclose(own.state.U.numpy(), st_r.U, rtol=0, atol=5e-5)
        np.testing.assert_allclose(dg_i.ergodic_metric.numpy(), dg_r.ergodic_metric, rtol=1e-5,
                                   atol=1e-7)
        for f in ("collision_code", "dwa_active", "dwa_feasible", "diverged", "orbit_reset"):
            np.testing.assert_array_equal(getattr(dg_i, f).numpy(), getattr(dg_r, f))
        np.testing.assert_array_equal(own.state.rng.numpy(), st_r.rng.astype(np.int64))
        for f in RingBuffer._fields:
            np.testing.assert_array_equal(getattr(own.state.buffer, f).numpy(),
                                          getattr(st_r.buffer, f))
        np.testing.assert_array_equal(own.state.hist_count.numpy(), st_r.hist_count)
    assert (own.state.buffer.count == OPTS["buffer_capacity"]).all()  # the ring wrapped


def test_in_place_closed_loop_bodies_match_functional():
    """The closed loops' bodies: ``_ticks`` (``explore``'s graphs) and
    ``_mapping_refresh`` (``explore_mapping_fused``'s) with the ring appended
    in place equal their functional runs bit for bit, over a wrap; so does
    ``replan_batched_fused`` with its advance, and the fused node's tick."""
    eng, sc, world, phik, gmm, dom, data, _ = _case(CONFIGS["fused_per_scenario_draws"])
    own = graphs.clone(sc)
    a = eng._ticks(TICKS, sc, phik, world)
    b = eng._ticks(TICKS, own, phik, world, ring_in_place=True)
    assert _equal(a, b) and b[0].state.buffer.states is own.state.buffer.states
    st = graphs.clone(sc.state)
    cfg = eng.config
    f = sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb, phik, world, advance=True)
    i = sk.replan_batched_fused(cfg, eng.model, st, sc.x, sc.vb, phik, world, advance=True,
                                ring_in_place=True)
    assert _equal(f, i) and i[0].buffer.states is st.buffer.states
    truth = GridMap(torch.from_numpy(data), torch.zeros((S, 2)), torch.full((S,), RES))
    belief = truth._replace(data=torch.full_like(truth.data, -1.0))
    truth, win = eng._mapping_setup(sc, truth, 1.0)
    own = graphs.clone(sc)
    a = eng._mapping_refresh(sc, belief, truth, win, TICKS, 1.0, 0)
    b = eng._mapping_refresh(own, belief, truth, win, TICKS, 1.0, 0, ring_in_place=True)
    assert _equal(a, b) and b[0].state.buffer.states is own.state.buffer.states
    node = ExplorationNode(cfg, target=(gmm.means[0].numpy(), gmm.covs[0].numpy(),
                                        gmm.weights[0].numpy()), device="cpu")
    node.on_map(data[0], 0.0, 0.0, RES)
    node.on_odom(sc.x[0].numpy(), np.zeros(3, np.float32))
    node.step()
    state = node.state
    own = graphs.clone(state)
    for _ in range(TICKS):
        state, pa = node._tick(state)
        own_next, pb = node._tick(own, ring_in_place=True)
        assert _equal((state, pa), (own_next, pb))
        assert own_next.buffer.states is own.buffer.states
        own = own_next
