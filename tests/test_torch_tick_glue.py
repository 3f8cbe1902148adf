"""The tick's glue (``ops/tick_glue.py``): ``glue_pre_plain`` and
``glue_post_plain``, the plain versions of the two glue kernels, against the
JAX package's pieces of the same work (``jax.random.split`` with the
partitionable threefry, ``ops/buffer.py``'s ``uniform01`` and ring,
``controller.orbit_guard``, the patch start of ``ops/patch.py`` and the tail
of ``ops/solve_kernel.py::replan_batched_fused``), and one fused tick through
the plain glue against the JAX package's vmapped step.

Integers, keys, flags and indices are held equal; the shared draw's history
sums within 1e-6 (a batched product against another); a tick within the
parity budgets of tests/test_solve_kernel.py (controls 5e-5, metric rtol
1e-5, codes and DWA flags exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.controller import orbit_guard as j_orbit_guard
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.models import make_model as j_make_model
from ergodic_exploration_tpu.ops import basis as jbasis
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu.ops.buffer import RingBuffer as JRingBuffer
from ergodic_exploration_tpu.ops.buffer import uniform01 as j_uniform01
from ergodic_exploration_tpu.ops.distance import DistanceField as JDistanceField
from ergodic_exploration_tpu.ops.integrator import rollout as j_rollout
from ergodic_exploration_tpu.ops.patch import extract_patch as j_extract_patch
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops import tick_glue as tg
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S, CAP, W = 12, 16, 6


def ring_case(seed=0, S=S, cap=CAP, wrap=True):
    """A ring of ``cap`` positions a scenario: every third scenario just
    wrapped (cursor < W, count = cap), every fourth still filling (count =
    cursor), scenario 1 empty; keys, poses, a warm start."""
    rng = np.random.default_rng(seed)
    states = rng.uniform(0.2, 2.8, (S, 2, cap)).astype(np.float32)
    cursor = rng.integers(0, cap, S).astype(np.int32)
    count = np.full(S, cap, np.int32)
    if wrap:
        cursor[::3] = rng.integers(0, W, len(cursor[::3]))
    count[::4] = cursor[::4]
    count[1], cursor[1] = 0, 0
    keys = rng.integers(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([rng.uniform(0.2, 2.8, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                       axis=1).astype(np.float32)
    # a third of the poses sit on the position orbit_window ticks back
    back = (cursor - min(W, cap)) % cap
    near = np.arange(S) % 3 == 0
    x[near, 0] = states[near, 0, back[near]] + 0.01
    x[near, 1] = states[near, 1, back[near]]
    return states, cursor, count, keys, x, rng.normal(0, 1, (S, 20, 2)).astype(np.float32)


def torch_ring(states, cursor, count):
    return RingBuffer(torch.from_numpy(states), torch.from_numpy(cursor),
                      torch.from_numpy(count))


def jax_ring(states, cursor, count):
    return JRingBuffer(jnp.asarray(states), jnp.asarray(cursor), jnp.asarray(count))


def _cfg(**kw):
    return default_config("cart").replace(**{**dict(buffer_capacity=CAP, orbit_window=W,
                                                    buffer_batch=10, num_basis=5), **kw})


def _dom(S_=S):
    return Domain(torch.zeros(S_, 2), torch.full((S_, 2), 3.0))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_scenario"])
def test_keys_are_jax_partitionable_split(shared):
    """The next keys (glue_post: counter 0 of the split) and the draw keys
    (glue_pre: counter 1, seen through the draws) are jax.random.split's,
    one split of row 0 broadcast under the shared draw."""
    states, cursor, count, keys, x, U = ring_case(1)
    if shared:
        keys[:] = keys[0]
    cfg = _cfg(shared_history_draw=shared)
    tk = torch.from_numpy(keys.astype(np.int64))
    post = tg.glue_post_plain(cfg, shared, torch.from_numpy(U), None,
                              torch_ring(states, cursor, count), torch.zeros(S, dtype=torch.int32),
                              tk, torch.from_numpy(x))
    ref = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys)))
    np.testing.assert_array_equal(post.rng.numpy(), ref[:, 0].astype(np.int64))
    pre = tg.glue_pre_plain(cfg, "nb", tk, torch_ring(states, cursor, count),
                            torch.from_numpy(U), torch.from_numpy(x), _dom())
    s_ref, n_ref = jax.vmap(lambda b, k: b.sample_states(10, k))(
        jax_ring(states, cursor, count), jnp.asarray(ref[:, 1]))
    np.testing.assert_array_equal(pre.hist.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(pre.nh.numpy(), np.asarray(n_ref))


def test_shared_draw_is_jax_uniform01_indices():
    """The shared draw: idx = floor(uniform01(key) * max(count_0, 1)) in
    float32 (ops/buffer.py), gathered from every ring; its sums are the JAX
    tick's compaction and reduction within 1e-6; an empty ring sums to 0."""
    states, cursor, count, keys, x, U = ring_case(2)
    keys[:] = keys[0]
    count[0] = 11  # the draw reads row 0's count, not a power of two
    cfg = _cfg(shared_history_draw=True)
    dom = _dom()
    pre = tg.glue_pre_plain(cfg, "sums", torch.from_numpy(keys.astype(np.int64)),
                            torch_ring(states, cursor, count), torch.from_numpy(U),
                            torch.from_numpy(x), dom)
    sub0 = jax.random.split(jnp.asarray(keys[0]))[1]
    u = j_uniform01(sub0, 10)
    idx = np.asarray(jnp.floor(u * jnp.float32(11)).astype(jnp.int32))
    assert idx.max() < 11
    s_buf = np.transpose(states[:, :, idx], (0, 2, 1))  # (S, nb, 2)
    jdom = JDomain.create(0.0, 0.0, 3.0, 3.0)
    Cx, Cy = jax.vmap(lambda p: jbasis.cos_tables(p, 5, jdom))(jnp.asarray(s_buf))
    hk = jbasis.hk_norm(5, jdom.lengths)
    w = (count > 0).astype(np.float32)[:, None, None]
    ref = np.asarray(jnp.matmul(jnp.swapaxes(Cx, 1, 2), Cy,
                                precision=jax.lax.Precision.HIGHEST)) * (w / np.asarray(hk))
    np.testing.assert_allclose(pre.hist.numpy(), ref.reshape(S, 25), rtol=0, atol=1e-6)
    assert (pre.hist[1] == 0).all() and pre.nh[1] == 0 and (pre.nh[count > 0] == 10).all()


# history, a count past the capacity (scenario 5) or None
HIST_ONE_CASES = {
    "full_ring": ("ring", None),
    "full_ring_count_past_cap": ("ring", CAP + 5),
    "accumulate": ("accumulate", None),
}


@pytest.mark.parametrize("case", list(HIST_ONE_CASES))
def test_full_ring_and_accumulate_match_jax_hist_one(case):
    """glue_pre_plain in modes "full" (``buffer_batch`` None) and
    "accumulate" against the two branches of the JAX tick's ``hist_one``
    (ops/solve_kernel.py:845-852): the JAX package's ``basis.cos_tables``,
    ``sample_mask(None)`` and ``coefficients_cos`` vmapped over the same
    numpy-seeded rings (still filling, full, just wrapped, empty, a count
    past the capacity) within rtol 1e-6 (atol 2e-6); the state counts (the mask's sum,
    ``hist_count`` as float32) equal, ``ck_sum`` handed on as it is."""
    history, past = HIST_ONE_CASES[case]
    states, cursor, count, keys, x, U = ring_case(7)
    if past is not None:
        count[5] = past
    rng = np.random.default_rng(7)
    hc = rng.integers(0, 5000, S).astype(np.int32)
    cks = rng.normal(0, 1, (S, 5, 5)).astype(np.float32)
    cfg = _cfg(buffer_batch=None, history=history)
    mode = tg.history_mode(cfg, fused=False)
    assert mode == ("full" if history == "ring" else "accumulate")
    assert tg.history_mode(cfg, fused=True) == mode
    pre = tg.glue_pre_plain(cfg, mode, torch.from_numpy(keys.astype(np.int64)),
                            torch_ring(states, cursor, count), torch.from_numpy(U),
                            torch.from_numpy(x), _dom(), None, torch.from_numpy(hc),
                            torch.from_numpy(cks))
    jdom = JDomain.create(0.0, 0.0, 3.0, 3.0)

    def hist_one(buf, ck_sum, hist_count):
        hkl = jbasis.hk_norm(5, jdom.lengths)
        if history == "ring":
            Cbx, Cby = jbasis.cos_tables(buf.positions, 5, jdom)
            w_buf = buf.sample_mask(None, None)
            return jbasis.coefficients_cos(Cbx, Cby, w_buf, hkl), jnp.sum(w_buf)
        return ck_sum, hist_count.astype(jnp.float32)

    ref_h, ref_n = jax.vmap(hist_one)(jax_ring(states, cursor, count), jnp.asarray(cks),
                                      jnp.asarray(hc))
    # rtol 1e-6, and atol 2e-6 where the terms cancel: the two products sum up
    # to CAP = 16 terms of magnitude <= 1 in another order, and a partial sum
    # near 16 rounds by up to 9.5e-7 a step
    np.testing.assert_allclose(pre.hist.numpy(), np.asarray(ref_h).reshape(S, 25), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_array_equal(pre.nh.numpy(), np.asarray(ref_n))
    if history == "ring":
        assert (pre.hist[1] == 0).all() and pre.nh[1] == 0
        assert pre.nh[5] == (CAP if past is not None else min(count[5], CAP))


def test_orbit_guard_right_after_a_wrap():
    """cursor < orbit_window and count = cap: the pose W ticks back is read
    through the floor-mod index (cursor - W) % cap, as in the JAX guard; the
    warm start of a guarded scenario is zeroed."""
    states, cursor, count, keys, x, U = ring_case(3)
    wrapped = (cursor < W) & (count == CAP)
    assert wrapped.sum() >= 3
    cfg = _cfg()
    pre = tg.glue_pre_plain(cfg, None, torch.from_numpy(keys.astype(np.int64)),
                            torch_ring(states, cursor, count), torch.from_numpy(U),
                            torch.from_numpy(x), _dom())
    jcfg = j_default_config("cart").replace(buffer_capacity=CAP, orbit_window=W)
    ref = np.asarray(jax.vmap(lambda b, p: j_orbit_guard(jcfg, b, p))(
        jax_ring(states, cursor, count), jnp.asarray(x[:, :2])))
    np.testing.assert_array_equal(pre.orbiting.numpy(), ref)
    assert ref[wrapped].any() and not ref.all()
    np.testing.assert_array_equal(pre.U.numpy(), np.where(ref[:, None, None], 0.0, U))
    assert pre.hist is None and pre.nh is None and pre.pstart is None


def test_ring_append_at_the_wrap():
    """The append writes the cursor's slot; cursor cap - 1 wraps to 0, the
    count saturates at cap, hist_count grows by one (JAX RingBuffer.append)."""
    states, cursor, count, keys, x, U = ring_case(4)
    cursor[2], count[2] = CAP - 1, CAP
    post = tg.glue_post_plain(_cfg(), False, torch.from_numpy(U), None,
                              torch_ring(states, cursor, count),
                              torch.arange(S, dtype=torch.int32),
                              torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(x))
    ref = jax.vmap(lambda b, p: b.append(p))(jax_ring(states, cursor, count),
                                             jnp.asarray(x[:, :2]))
    np.testing.assert_array_equal(post.buffer.states.numpy(), np.asarray(ref.states))
    np.testing.assert_array_equal(post.buffer.cursor.numpy(), np.asarray(ref.cursor))
    np.testing.assert_array_equal(post.buffer.count.numpy(), np.asarray(ref.count))
    assert post.buffer.cursor[2] == 0
    np.testing.assert_array_equal(post.hist_count.numpy(), np.arange(S) + 1)


def jax_tail(U_new, code, u_dwa):
    """The tail of the JAX replan_batched_fused after its kernel (safety on):
    DWA select, divergence guard, warm-start shift."""
    U_new, code, u_dwa = map(jnp.asarray, (U_new, code, u_dwa))
    use_dwa = code >= 2
    u_cmd = jnp.where(use_dwa[:, None], u_dwa, U_new[:, 0])
    diverged = ~(jnp.all(jnp.isfinite(U_new), axis=(1, 2)) & jnp.all(jnp.isfinite(u_cmd), axis=1))
    U_new = jnp.where(diverged[:, None, None], 0.0, U_new)
    u_cmd = jnp.where(diverged[:, None], 0.0, u_cmd)
    U_next = jnp.concatenate([U_new[:, 1:], jnp.zeros_like(U_new[:, :1])], axis=1)
    return tuple(map(np.asarray, (U_next, u_cmd, use_dwa, diverged)))


@pytest.mark.parametrize("where", ["U_new", "u_dwa"])
def test_divergence_guard_with_nan_and_inf(where):
    """NaN and inf in the solve or in the DWA control: the scenario's
    controls are zeroed and flagged, only where the bad value is used (a
    non-finite u_dwa of a scenario that keeps u0 is not)."""
    states, cursor, count, keys, x, U = ring_case(5)
    code = np.array([0, 2, 3, 1] * (S // 4), np.int32)
    u_dwa = np.random.default_rng(5).normal(0, 1, (S, 2)).astype(np.float32)
    bad = U if where == "U_new" else u_dwa
    bad[0].flat[-1] = np.nan
    bad[1].flat[1] = np.inf
    bad[2].flat[0] = -np.inf
    bad[3].flat[0] = np.nan
    feas = (code != 3).astype(np.int32)
    post = tg.glue_post_plain(_cfg(), False, torch.from_numpy(U),
                              (torch.from_numpy(code), torch.from_numpy(u_dwa),
                               torch.from_numpy(feas)),
                              torch_ring(states, cursor, count), torch.zeros(S, dtype=torch.int32),
                              torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(x))
    U_next, u_cmd, use_dwa, diverged = jax_tail(U, code, u_dwa)
    np.testing.assert_array_equal(post.U.numpy(), U_next)
    np.testing.assert_array_equal(post.u.numpy(), u_cmd)
    np.testing.assert_array_equal(post.dwa_active.numpy(), use_dwa)
    np.testing.assert_array_equal(post.diverged.numpy(), diverged)
    np.testing.assert_array_equal(post.feasible.numpy(), feas.astype(bool))
    want = [True, True, True, True] if where == "U_new" else [False, True, True, False]
    assert diverged[:4].tolist() == want and not diverged[4:].any()


def test_patch_starts_at_half_cell_ties():
    """Poses whose cell coordinate is k + 0.5 round half to even, as
    jnp.round in the JAX patch extraction; the starts are int32."""
    P, res = 24, 0.05
    ks = np.arange(-3, 9, dtype=np.float32)
    cf = ks + 0.5  # ties
    x = np.stack([(cf + 0.5) * res, (cf[::-1] + 0.5) * res, np.zeros_like(cf)], 1)
    x = x.astype(np.float32)
    n = len(ks)
    org, resn = torch.zeros(n, 2), torch.full((n,), res)
    got = tg.glue_pre_plain(_cfg(orbit_window=0), None, torch.zeros(n, 2, dtype=torch.int64),
                            RingBuffer.create(CAP, n), torch.zeros(n, 20, 2),
                            torch.from_numpy(x), _dom(n), tg.PatchGeometry(org, resn, P)).pstart
    field = JDistanceField(jnp.zeros((100, 100)), jnp.zeros((100, 100, 2)), jnp.zeros(2),
                           jnp.float32(res))
    ref = np.stack([np.asarray(j_extract_patch(field, jnp.asarray(p[:2]), P).start) for p in x])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    cfx = (x[:, 0] - 0.0) / np.float32(res) - np.float32(0.5)
    assert np.any(np.abs(cfx - np.floor(cfx) - 0.5) == 0)  # the ties are exact in float32


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_advance_is_the_plant_step(model):
    """glue_post's advance: one RK4 step of dt through the true kinematics of
    the emitted control and its body twist (JAX rollout and twist)."""
    states, cursor, count, keys, x, _ = ring_case(6)
    cfg = default_config(model).replace(buffer_capacity=CAP)
    U = np.random.default_rng(6).normal(0, 2, (S, 20, cfg.nu)).astype(np.float32)
    post = tg.glue_post_plain(cfg, False, torch.from_numpy(U), None,
                              torch_ring(states, cursor, count), torch.zeros(S, dtype=torch.int32),
                              torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(x),
                              advance=True)
    jm = j_make_model(j_default_config(model))
    ref = np.asarray(jax.vmap(lambda p, u: j_rollout(jm, p, u[None], cfg.dt)[-1])(
        jnp.asarray(x), jnp.asarray(U[:, 0])))
    np.testing.assert_allclose(post.x.numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(post.vb.numpy(), np.asarray(jax.vmap(jm.twist)(U[:, 0])),
                               rtol=0, atol=1e-6)


TICK_CASES = {
    "shared_draw_sums": dict(shared_history_draw=True, shared_maps=True),
    "per_scenario_draws": dict(shared_history_draw=False, shared_maps=False),
    "full_ring": dict(shared_history_draw=True, shared_maps=True, buffer_batch=None),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_fused_tick_through_plain_glue_matches_jax_vmapped(case):
    """One replan_batched_fused tick (the plain glue around K1's plain
    version) and its advance against the JAX engine's vmapped step
    (use_fused_solve=False) from the same warm state."""
    opts = dict(num_basis=6, buffer_capacity=64, grid_samples=(30, 30), **TICK_CASES[case])
    rng = np.random.default_rng(7)
    n = 8
    x0 = np.concatenate([rng.uniform(0.4, 2.6, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    jcfg = j_default_config("cart").replace(use_fused_solve=False, use_pallas=False, **opts)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (n, 60, 60)),
                                   jnp.zeros((n, 2)), jnp.full((n,), 0.05)))
    jg = jtarget.GaussianMixture.create(rng.uniform(0.5, 2.5, (n, 2, 2)).astype(np.float32),
                                        np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None],
                                                (n, 2, 1, 1)))
    phik = je.phik_from_gmm(jg, JDomain.create(0.0, 0.0, 3.0, 3.0), jw)
    jsc = je.init_scenarios(x0)
    for _ in range(4):
        jsc, _, _ = je.replan(jsc, phik, jw)
    sc_np = jax.tree.map(np.asarray, jsc)  # replan donates its scenarios
    sc_r, u_r, dg_r = jax.tree.map(np.asarray, je.replan(jsc, phik, jw))
    st_r = sc_r.state
    x_r = np.asarray(jax.vmap(lambda p, u: j_rollout(je.controller.model, p, u[None],
                                                     jcfg.dt)[-1])(jnp.asarray(sc_np.x),
                                                                   jnp.asarray(u_r)))

    cfg = default_config("cart").replace(use_fused_solve=True, **opts)
    eng = Engine(cfg, device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    sc = interop.scenarios_from_numpy(sc_np, device="cpu")
    st, u, dg, x1, vb1 = sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb,
                                                 torch.from_numpy(np.array(phik)), world,
                                                 advance=True)
    np.testing.assert_allclose(u.numpy(), u_r, rtol=0, atol=5e-5)
    np.testing.assert_allclose(st.U.numpy(), st_r.U, rtol=0, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric.numpy(), dg_r.ergodic_metric, rtol=1e-5,
                               atol=1e-7)
    for f in ("collision_code", "dwa_active", "dwa_feasible", "diverged", "orbit_reset"):
        np.testing.assert_array_equal(getattr(dg, f).numpy(), getattr(dg_r, f))
    np.testing.assert_array_equal(st.rng.numpy(), st_r.rng.astype(np.int64))
    np.testing.assert_array_equal(st.buffer.cursor.numpy(), st_r.buffer.cursor)
    np.testing.assert_array_equal(st.buffer.count.numpy(), st_r.buffer.count)
    np.testing.assert_array_equal(st.hist_count.numpy(), st_r.hist_count)
    np.testing.assert_array_equal(st.buffer.states.numpy(), st_r.buffer.states)
    np.testing.assert_allclose(x1.numpy(), x_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vb1.numpy(), np.asarray(jax.vmap(je.controller.model.twist)(
        jnp.asarray(u_r))), rtol=0, atol=1e-5)


def test_engine_builds_the_lattice_once_per_geometry():
    """replan_refresh's lattice operands are cached on the tensors of the
    domain and mask and their versions: the same geometry hits, an in-place
    change to the mask builds anew."""
    cfg = default_config("cart").replace(use_fused_solve=True, shared_maps=True, num_basis=4,
                                         grid_samples=(10, 10))
    eng = Engine(cfg, device="cpu")
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    mask = torch.ones(3, 100)
    a = eng._lattice_ops(dom, mask)
    assert eng._lattice_ops(dom, mask) is a
    mask[:, :10] = 0.0
    b = eng._lattice_ops(dom, mask)
    assert b is not a and not torch.equal(a.D, b.D)
    ref = sk.lattice_operands(cfg, dom, mask)
    for got, want in zip(b, ref):
        assert torch.equal(got, want)


def test_dispatch_takes_the_plain_glue_on_the_cpu_only():
    """CPU tensors go to the plain versions (nothing is counted or built);
    anything but a CPU or CUDA tensor is refused."""
    tg.G.reset_launches()
    states, cursor, count, keys, x, U = ring_case(8)
    cfg = _cfg()
    tk = torch.from_numpy(keys.astype(np.int64))
    tg.glue_pre(cfg, "nb", tk, torch_ring(states, cursor, count), torch.from_numpy(U),
                torch.from_numpy(x), _dom())
    tg.glue_post(cfg, False, torch.from_numpy(U), None, torch_ring(states, cursor, count),
                 torch.zeros(S, dtype=torch.int32), tk, torch.from_numpy(x))
    assert sum(tg.G.launches.values()) == 0 and tg.G.built is None
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tg.glue_post(cfg, False, torch.from_numpy(U).to("meta"), None,
                     torch_ring(states, cursor, count), torch.zeros(S, dtype=torch.int32), tk,
                     torch.from_numpy(x).to("meta"))
