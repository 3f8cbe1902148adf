"""K1's module: the port's replan_batched_fused (plain version of the kernel,
on CPU tensors) against the JAX replan_batched_fused running its Pallas
kernel in interpret mode, one tick with the in-kernel GMM refresh (cart).

Tolerances are those of tests/test_solve_kernel.py: controls atol 5e-5,
metric rtol 1e-5 / atol 1e-7, ck_sum rtol 1e-5 / atol 5e-6 (the JAX kernel
builds cos(k theta) by Chebyshev recurrence, the port directly), codes and
DWA flags exact.
"""

import math

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
from ergodic_exploration_tpu.ops.solve_kernel import replan_batched_fused as j_replan_fused
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S = 8
OPTS = dict(num_basis=6, buffer_capacity=64, grid_samples=(30, 30), shared_maps=True,
            shared_history_draw=True)


def _case(seed=3):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.4, 2.6, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    means = rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    return x0, data, means, covs, np.ones((S, 2), np.float32)


@pytest.fixture(scope="module")
def one_tick():
    """Both packages' fused tick from the same warm state (3 ticks of history)."""
    x0, data, means, covs, w = _case()
    jcfg = j_default_config("cart").replace(use_fused_solve=True, use_pallas=False, **OPTS)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                   jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    jg = jtarget.GaussianMixture.create(means, covs, w)
    jd = JDomain.create(0.0, 0.0, 3.0, 3.0)
    jsc = je.init_scenarios(x0)
    warm = JEngine(jcfg.replace(use_fused_solve=False))
    phik = warm.phik_from_gmm(jg, jd, jw)
    for _ in range(3):  # warm history through the vmapped controller
        jsc, _, _ = warm.replan(jsc, phik, jw)
    sc_np = jax.tree.map(np.asarray, jsc)
    model = je.controller.model
    st, u, dg = j_replan_fused(jcfg, model, jsc.state, jsc.x, jsc.vb, None, jw,
                               gmm=jg, domain=jd)
    ref = jax.tree.map(np.asarray, (st, u, dg))

    cfg = default_config("cart").replace(use_fused_solve=True, **OPTS)
    eng = Engine(cfg, device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    sc = interop.scenarios_from_numpy(sc_np, device="cpu")
    sk.K1.reset_launches()
    out = sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb, None, world,
                                  gmm=GaussianMixture.create(means, covs, w),
                                  domain=Domain.create(0.0, 0.0, 3.0, 3.0))
    return ref, interop.to_numpy(out), sum(sk.K1.launches.values())


def test_fused_tick_matches_jax_kernel(one_tick):
    (st_r, u_r, dg_r), (st, u, dg), _ = one_tick
    np.testing.assert_allclose(u, u_r, atol=5e-5)
    np.testing.assert_allclose(st.U, st_r.U, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dg.barrier_cost, dg_r.barrier_cost, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
    np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
    np.testing.assert_array_equal(dg.orbit_reset, dg_r.orbit_reset)
    np.testing.assert_allclose(st.ck_sum, st_r.ck_sum, rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(st.buffer.states, st_r.buffer.states, atol=1e-6)
    np.testing.assert_array_equal(st.rng, st_r.rng.astype(np.int64))


@pytest.mark.parametrize("shared_maps", [True, False], ids=["shared_map", "per_scenario_maps"])
def test_per_scenario_history_draws_reach_k1_as_positions(shared_maps):
    """Ring history with a sampled batch and per-scenario draws: the tick
    hands K1 the (S, nb, 2) drawn positions, not their sums, as the JAX tick
    hands them to its kernel (its ``nb > 0`` variant, here in interpret mode);
    one tick from a warm state agrees within the budgets above."""
    x0, data, means, covs, w = _case()
    opts = dict(OPTS, shared_maps=shared_maps, shared_history_draw=False, buffer_batch=24)
    jcfg = j_default_config("cart").replace(use_fused_solve=True, use_pallas=False, **opts)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                   jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    warm = JEngine(jcfg.replace(use_fused_solve=False))
    phik = warm.phik_from_gmm(jtarget.GaussianMixture.create(means, covs, w),
                              JDomain.create(0.0, 0.0, 3.0, 3.0), jw)
    jsc = je.init_scenarios(x0)
    for _ in range(3):
        jsc, _, _ = warm.replan(jsc, phik, jw)
    st_r, u_r, dg_r = jax.tree.map(np.asarray, j_replan_fused(
        jcfg, je.controller.model, jsc.state, jsc.x, jsc.vb, phik, jw))

    cfg = default_config("cart").replace(use_fused_solve=True, **opts)
    eng = Engine(cfg, device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    sc = interop.scenarios_from_numpy(jax.tree.map(np.asarray, jsc), device="cpu")
    tphik = torch.from_numpy(np.array(phik))
    inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, tphik, world)
    assert inp.hist.shape == (S, 24, 2) and inp.dist.dim() == (2 if shared_maps else 3)
    assert (inp.nh == 24.0).all()
    st, u, dg = interop.to_numpy(sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb,
                                                         tphik, world))
    np.testing.assert_allclose(u, u_r, atol=5e-5)
    np.testing.assert_allclose(st.U, st_r.U, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
    np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
    np.testing.assert_array_equal(st.rng, st_r.rng.astype(np.int64))
    # the shared draw and the full ring still reach K1 as (S, K^2) sums
    for other in (dict(shared_history_draw=True), dict(buffer_batch=None)):
        c2 = cfg.replace(**other)
        assert sk.fused_tick_inputs(c2, sc.state, sc.x, sc.vb, tphik, world)[0].hist.shape == (
            S, cfg.num_basis ** 2)


def test_launch_counter_stays_zero_on_cpu(one_tick):
    """CPU tensors go to the plain version: the kernel is never launched."""
    assert one_tick[2] == 0
    assert sum(sk.K1.launches.values()) == 0 and sk.K1.built is None


def test_kernel_params_mirror_the_c_struct():
    """The ctypes parameter block carries the float32 constants as the
    plain version rounds them."""
    cfg = default_config("omni")
    sp = sk.params_from_config(cfg, 40, (100, 100), 2, True)
    sps = sk.safety_params_from_config(cfg, 16)
    p = sk._c_params(sp, sps, S=7, lattice=(100, 100))
    assert (p.S, p.K, p.nu, p.P, p.Pc, p.J, p.masked, p.model) == (7, 10, 4, 40, 16, 2, 1, 1)
    assert p.patch_hi == np.float32(40 - 1.001) and p.crop_hi == np.float32(16 - 1.001)
    assert p.tw_b == np.float32(0.25 * cfg.omni.wheel_radius / (cfg.omni.lx + cfg.omni.ly))
    assert list(p.r_inv) == [np.float32(1.0) / np.float32(0.001)] * 4
    assert (p.safety, p.nb) == (1, 0) and sk._c_params(sp, sps, 7, (0, 0), False, 24).nb == 24
    assert (p.nsx, p.nsy, p.nband, p.band_rows) == (100, 100, 1, 0)
    q = sk._c_params(sp, sps, 7, (100, 100), plan=sk.RefreshPlan(17, 6))
    assert (q.nband, q.band_rows) == (17, 6)
    assert p.global_tables == 0
    assert sk._c_params(sp, sps, 7, (100, 100), plan=sk.RefreshPlan(17, 6),
                        tables_global=True).global_tables == 1
    assert [f[0] for f in sk._Buffers._fields_] == list(sk._BUFFERS)
    # the struct in the source lists the same fields in the same order
    src = open(sk.__file__.replace("ops/solve_kernel.py", "csrc/solve_kernel.cu")).read()
    body = src[src.index("struct K1Params {"):src.index("// Mirror of ops/solve_kernel.py::_Buffers")]
    import re
    names = re.findall(r"\b([A-Za-z_][A-Za-z_0-9]*)(?:\[\d\])?\s*[,;]", re.sub(r"//.*", "", body))
    assert names == [f[0] for f in sk._Params._fields_]


def test_unported_variants_raise():
    """Tensors that lie neither on the CPU nor on a CUDA device raise in
    every variant's wrapper, and the kernel object itself refuses anything
    but CUDA tensors: nothing carries on with the plain version unasked."""
    cfg = default_config("cart")
    meta = torch.zeros(1, device="meta")
    inp = sk.K1Inputs(*([meta] * len(sk.K1Inputs._fields)))
    for fn in (sk.fused_solve_safety, sk.fused_solve):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(cfg, inp)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.fused_safety(cfg, *([meta] * 9))
    cpu = sk.K1Inputs(*([torch.zeros(1)] * len(sk.K1Inputs._fields)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.K1(cfg, cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.K1.safety(cfg, *([torch.zeros(1)] * 9))


def test_refresh_lattice_is_padded_to_the_chunk():
    cfg = default_config("cart").replace(grid_samples=(30, 30), num_basis=6)
    dom = Domain.create(0.0, 0.0, 3.0, 3.0)
    g = GaussianMixture.create(np.full((2, 1, 2), 1.5, np.float32),
                               np.tile(np.eye(2, dtype=np.float32)[None, None], (2, 1, 1, 1)))
    mask = torch.ones(2, 900)
    mask[:, :100] = 0.0
    r = sk.refresh_operands(cfg, g, dom, mask)
    assert r.pts.shape == (960, 2) and r.D.shape == (960, 36) and r.masked
    assert (r.D[900:] == 0).all() and (r.pts[900:] == sk.PAD_POINT).all()
    assert (r.D[:100] == 0).all()
    phik = sk.refresh_plain(r, torch.full((2, 2), 3.0)).view(2, 6, 6)
    assert torch.isfinite(phik).all()


# ---------------------------------------------------------------------------
# the refresh's lattice split and ordered finish; the DWA winner rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_,want", [(1, (157, 1)), (100, (79, 2)), (4096, (8, 20))])
def test_lattice_split_is_shared_by_k1_and_k2(S_, want):
    """One function chooses the split for K1's refresh and for K2 (157 chunks:
    the 100 x 100 lattice; 132 SMs): whole rounds of the blocks that run at a
    time, at most MAX_RUN chunks a split, never more splits than chunks."""
    from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk

    assert gk.lattice_split is sk.lattice_split
    nsplit, per = sk.lattice_split(S_, 157, 132)
    assert (nsplit, per) == want
    assert (nsplit - 1) * per < 157 <= nsplit * per and per <= sk.MAX_RUN
    blocks, slots = -(-S_ // sk.TILE_S) * nsplit, sk.BLOCKS_PER_SM * 132
    if S_ == 4096:  # two rounds of the blocks that run at a time, the second 94 % full
        assert 1.9 * slots < blocks <= 2 * slots
    else:  # a small batch is spread over the card in one round
        assert slots / 2 < blocks <= slots


def test_refresh_scratch_is_allocated_once_per_shape():
    k1 = sk.FusedSolveSafety()
    cpu = torch.device("cpu")
    rows = k1.refresh_scratch(cpu, 100, 10, 4096)
    assert rows.shape == (128, 100, 11, 32) and rows.dtype == torch.float32
    assert k1.refresh_scratch(cpu, 100, 10, 4096) is rows  # not per tick
    assert k1.refresh_scratch(cpu, 100, 10, 1).shape == (1, 100, 11, 32)


def test_solve_workspace_is_allocated_once_per_size():
    """k1_solve's global tables: one tensor per size, the same for every
    later launch of that size (a graph captured on one keeps its pointer)."""
    k1 = sk.FusedSolveSafety()
    cpu = torch.device("cpu")
    ws = k1.solve_workspace(cpu, 512 * sk.solve_warp_floats(40, 256, 40))
    assert ws.numel() == 512 * 69252 and ws.dtype == torch.float32
    assert k1.solve_workspace(cpu, 512 * 69252) is ws  # not per tick
    assert k1.solve_workspace(cpu, 4 * 69252).numel() == 4 * 69252
    assert k1.solve_workspace(cpu, 512 * 69252) is ws


@pytest.mark.parametrize("S_,slabs", [(1, 2), (4096, 4), (4096, 7), (100, 2)])
def test_lattice_split_counts_the_slabs(S_, slabs):
    """The refresh's slabs on the grid's z axis count as blocks when the
    lattice split fills rounds of the blocks that run at a time: one slab
    is the split of before, more slabs take fewer splits."""
    nsplit, per = sk.lattice_split(S_, 157, 132, slabs)
    assert (nsplit - 1) * per < 157 <= nsplit * per and per <= sk.MAX_RUN
    assert nsplit <= sk.lattice_split(S_, 157, 132)[0]
    assert sk.lattice_split(S_, 157, 132, 1) == sk.lattice_split(S_, 157, 132)
    assert sk.slab_blocks(100) == 1 and sk.slab_blocks(257) == 2 and sk.slab_blocks(1600) == 7


def _refresh_split_and_finish(r, dlen, plan):
    """The refresh as k1_refresh + k1_finish compute it, in plain PyTorch:
    each band's rows, each row's y sums and tot (the bands only share the
    rows out among warps: every row's sums go to the scratch), then the x
    sums and the tot over each of k1_finish's 4 parts of the rows (LF_PARTS
    in csrc/lattice_refresh.cuh), the parts added in order; A_00 is the
    masked mass; then K1's epilogue."""
    from ergodic_exploration_tpu_torch.ops.target import gmm_eval

    nsx, K = r.cx.shape[0], math.isqrt(r.hk.shape[0])
    nsy = int((r.ys < sk.PAD_POINT).sum())
    S_ = r.gmm.weights.shape[0]
    phi = gmm_eval(r.pts[:nsx * nsy], r.gmm).view(S_, nsx, nsy)
    m = r.mask[:, :nsy] if r.mask is not None else torch.ones(nsx, nsy)
    rows = torch.zeros(S_, nsx, K)
    tots = torch.zeros(S_, nsx)
    for b in range(plan.nband):
        x = slice(b * plan.band_rows, (b + 1) * plan.band_rows)
        rows[:, x] = torch.matmul(phi[:, x] * m[x], r.cy[:K, :nsy].T)
        tots[:, x] = phi[:, x].sum(dim=-1)
    per = -(-nsx // 4)
    A, t = torch.zeros(S_, K, K), torch.zeros(S_, 1)
    for q in range(4):
        x = slice(q * per, (q + 1) * per)
        A = A + torch.einsum("xa,sxb->sab", r.cx[x, :K], rows[:, x])
        t = t + tots[:, x].sum(dim=-1, keepdim=True)
    acc = A.reshape(S_, K * K) / r.hk
    if r.masked:
        h00 = torch.sqrt(dlen[:, 0:1] * dlen[:, 1:2])
        a00 = h00 * (A[:, 0, 0:1] / r.hk[0])
        ok = (t > 1e-12) & (a00 / torch.clamp(t, min=1e-12) > 1e-12)
        ck = acc / torch.clamp(a00, min=1e-30)
    else:
        ok = t > 1e-12
        ck = acc / torch.clamp(t, min=1e-12)
    return torch.where(ok, ck, r.mask_ck)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("S_", [1, 5])
def test_split_and_finish_of_the_refresh_equals_refresh_plain(masked, S_):
    """2.2e-6: the JAX package's own budget for its refresh; the sums are
    the plain version's, factored over the lattice's rows and columns and
    shared out in row bands."""
    rng = np.random.default_rng(11)
    cfg = default_config("cart").replace(grid_samples=(50, 40), num_basis=6)
    dom = Domain.create(0.0, 0.0, 3.0, 3.0)
    means = rng.uniform(0.5, 2.5, (S_, 2, 2)).astype(np.float32)
    means[S_ - 1] = 400.0  # a mixture with no mass on the lattice: the fallback
    g = GaussianMixture.create(
        means, np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S_, 2, 1, 1)))
    mask = torch.from_numpy((rng.uniform(0, 1, 2000) > 0.3).astype(np.float32)) if masked else None
    r = sk.refresh_operands(cfg, g, dom, mask)
    dlen = torch.full((S_, 2), 3.0)
    ref = sk.refresh_plain(r, dlen)
    for plan in (sk.refresh_plan(S_, 50, 132), sk.RefreshPlan(7, 8), sk.RefreshPlan(1, 50)):
        got = _refresh_split_and_finish(r, dlen, plan)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0.0, atol=2.2e-6)
        np.testing.assert_array_equal(got[S_ - 1].numpy(), r.mask_ck.numpy())


@pytest.mark.parametrize("ns,K,masked", [((50, 40), 6, True), ((17, 19), 5, False),
                                         ((100, 100), 10, True), ((20, 16), 17, True)])
def test_lattice_operands_rebuild_the_dense_table(ns, K, masked):
    """The separable operands are the dense table's factors: cx (x) cy / h_k
    times the mask is D within float32 rounding, the samples are the
    lattice's points, and the padding (columns past nsy, coefficients past
    K) is far away or zero."""
    rng = np.random.default_rng(5)
    nsx, nsy = ns
    cfg = default_config("cart").replace(grid_samples=ns, num_basis=K)
    dom = Domain.create(0.5, -1.0, 4.0, 3.0)
    mask = (torch.from_numpy((rng.uniform(0, 1, (2, nsx * nsy)) > 0.3).astype(np.float32))
            if masked else None)
    lat = sk.lattice_operands(cfg, dom, mask)
    N = nsx * nsy
    grid = torch.stack(torch.broadcast_tensors(lat.xs[:, None], lat.ys[None, :nsy]), -1)
    assert torch.equal(grid.reshape(N, 2), lat.pts[:N])
    m = lat.mask[:, :nsy] if masked else torch.ones(nsx, nsy)
    assert masked == (lat.mask is not None) and (not masked or torch.equal(m.reshape(N), mask[0]))
    cx, cy = lat.cx[:, :K], lat.cy[:K, :nsy].T  # (nsx, K), (nsy, K)
    D = (cx[:, None, :, None] * cy[None, :, None, :] / lat.hk.view(K, K)
         * m[:, :, None, None]).reshape(N, K * K)
    np.testing.assert_allclose(D.numpy(), lat.D[:N].numpy(), rtol=0.0, atol=2.0 ** -23)
    assert (lat.ys[nsy:] == sk.PAD_POINT).all() and lat.ys.shape[0] % sk.ROW_CHUNK == 0
    assert lat.cx.shape == (nsx, sk.finish_cx_cols(K)) and lat.cy.shape[0] == K + K % 2
    assert (lat.cx[:, K:] == 0).all() and (lat.cy[K:] == 0).all() and (lat.cy[:, nsy:] == 0).all()
    assert not masked or (lat.mask[:, nsy:] == 0).all()
    assert torch.equal(lat.hk, sk.basis.hk_norm(K, dom.lengths).reshape(K * K))


@pytest.mark.parametrize("S_,nsx", [(1, 100), (4096, 100), (100, 100), (70, 17), (1, 3),
                                    (33, 250), (4096, 7)])
def test_refresh_plan_counts_every_row_once_and_fills_the_card(S_, nsx):
    """The bands cover the lattice's rows, each once (the last band may be
    short, none is empty); a small batch takes a band a row, as many warps as
    the lattice has rows, and a large one gives every SM about REFRESH_WARPS
    warps (132 SMs: an H100)."""
    plan = sk.refresh_plan(S_, nsx, 132)
    rows = [range(b * plan.band_rows, min(nsx, (b + 1) * plan.band_rows))
            for b in range(plan.nband)]
    assert sorted(i for r_ in rows for i in r_) == list(range(nsx)) and all(rows)
    warps, want = -(-S_ // 32) * plan.nband, sk.REFRESH_WARPS * 132
    if S_ == 1:  # one scenario: a row a warp
        assert plan == sk.RefreshPlan(nsx, 1)
    if (S_, nsx) == (4096, 100):  # 128 groups: 17 bands of 6 rows, 16.5 warps an SM
        assert plan == sk.RefreshPlan(17, 6) and want <= warps < 1.1 * want
    # a band a row, or enough bands to fill the card
    assert plan.nband == nsx or warps >= want


def _warp_winner(cost):
    """The DWA pick as a warp of k1_solve makes it: lane l scans candidates
    l, l + 32, ... in ascending order with a strict <, then a butterfly
    reduction keeps the smaller (cost, index) pair. Returns (index, cost)."""
    best, bidx = [float("inf")] * 32, [2**31 - 1] * 32
    for lane in range(32):
        for c in range(lane, len(cost), 32):
            if cost[c] < best[lane]:
                best[lane], bidx[lane] = cost[c], c
    o = 16
    while o:
        nb_, ni_ = list(best), list(bidx)
        for lane in range(32):
            ob, oi = best[lane ^ o], bidx[lane ^ o]
            if ob < best[lane] or (ob == best[lane] and oi < bidx[lane]):
                nb_[lane], ni_[lane] = ob, oi
        best, bidx, o = nb_, ni_, o // 2
    assert len(set(bidx)) == 1  # every lane ends with the same winner
    return bidx[0], best[0]


@pytest.mark.parametrize("model_name", ["cart", "omni"])
def test_smallest_cost_index_pair_is_the_plain_versions_pick(model_name):
    """Many candidates tie (n_vy = 1 repeats twists, a zero twist makes the
    window symmetric, a start inside an obstacle makes every candidate
    INFEASIBLE): the (cost, index) minimum is the first index reaching the
    minimum, which is what ``torch.argmin`` and so ``fused_safety_plain`` pick."""
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.ops import dwa as dwa_ops
    from ergodic_exploration_tpu_torch.ops.collision import CRASH, check_trajectory
    from ergodic_exploration_tpu_torch.ops.integrator import constant_twist_poses
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch

    S_ = 12
    rng = np.random.default_rng(17)
    cfg = default_config(model_name)
    eng = Engine(cfg, device="cpu")
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    world = eng.prepare_world(GridMap(torch.from_numpy(data).expand(S_, 60, 60).contiguous(),
                                      torch.zeros(S_, 2), torch.full((S_,), 0.05)))
    x = np.stack([rng.uniform(0.8, 2.2, S_), 1.4 - rng.uniform(0.22, 0.7, S_),
                  np.pi / 2 + rng.uniform(-0.6, 0.6, S_)], 1).astype(np.float32)
    x[-2:, 1] = 1.5  # inside the wall
    x = torch.from_numpy(x)
    u0 = torch.full((S_, cfg.nu), 4.0) * torch.from_numpy(
        rng.uniform(0.3, 1.0, (S_, 1)).astype(np.float32))
    vb = eng.model.twist(u0) * 0.5
    vb[::3] = 0.0
    crop = extract_patch(world.dist, x[:, :2], min(cfg.patch_cells, 60)).center_crop(
        cfg.safety_patch_cells)
    _, u_plain, feas_plain = sk.fused_safety_plain(
        cfg, x, vb, u0, crop.dist, crop.start.to(torch.int32), crop.origin, crop.resolution,
        world.domain.origin, world.domain.lengths)
    # the candidates' costs, as ops/dwa.py::dwa_control computes them
    us = eng.model.from_twist(dwa_ops.candidate_twists(vb, cfg.dwa))
    tws = eng.model.twist(us)
    ts = cfg.dwa.dt * torch.arange(1, cfg.dwa.horizon + 1, dtype=torch.float32)
    X = constant_twist_poses(x[:, None, :], tws, ts)
    codes = check_trajectory(X[..., :2], world.domain, crop, cfg.boundary_radius, cfg.d_safe)
    cost = ((us - u0[:, None, :]) ** 2).sum(dim=-1)
    cost = torch.where(codes >= CRASH, torch.full_like(cost, dwa_ops.INFEASIBLE_COST), cost)
    ties = 0
    for s in range(S_):
        row = cost[s].tolist()
        idx, c = _warp_winner(row)
        assert idx == int(torch.argmin(cost[s])) and c == min(row)
        ties += row.count(c) > 1
        feasible = c < dwa_ops.INFEASIBLE_COST
        assert feasible == bool(feas_plain[s])
        want = us[s, idx] if feasible else torch.zeros(cfg.nu)
        np.testing.assert_array_equal(u_plain[s].numpy(), want.numpy())
    assert ties >= 2 and not bool(feas_plain[-1])  # ties were there to be broken
