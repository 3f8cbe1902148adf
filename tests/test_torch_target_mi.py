"""The mutual-information half of ops/target.py and the separable basis
helpers of ops/basis.py: every function of the port against its JAX
counterpart on the same numpy inputs, one map and a batch of maps.

Tolerances: atol 1e-6 for per-cell fields made of the same float32
expressions; 3e-6 for a field that went through the box blur, whose running
sums the two frameworks take in another order (XLA scans in a tree, ATen in
sequence): the sums reach 31 here, where one float32 ulp is 1.9e-6, and a
blurred value is a difference of two of them (measured: 1.2e-6);
2e-5 for phi_k (sums of a few
hundred to a few thousand float32 terms in another order; the JAX package's
own budget between its paths, tests/test_target.py).

A 20 x 20 lattice on 40 x 40 maps of 0.05 m (and 23 x 23 on the 2 m domain)
puts no lattice point on a half-cell boundary, where the nearest-cell round
would depend on the last bit.
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
from ergodic_exploration_tpu.ops import basis as jbasis
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import basis, target

torch.set_num_threads(2)
S, H, W, K, NS = 6, 40, 40, 6, (20, 20)
FIELD_ATOL, BLUR_ATOL, PHIK_ATOL = 1e-6, 3e-6, 2e-5


def _beliefs(seed=3):
    """Beliefs with a known-free region of per-scenario extent, a wall, a
    band of probabilities on both sides of the threshold, one fully unknown
    and one fully occupied scenario."""
    rng = np.random.default_rng(seed)
    data = np.full((S, H, W), -1.0, np.float32)
    for s in range(S):
        data[s, :, :rng.integers(8, 30)] = 0.0
        data[s, 10:13, 4:16] = 1.0
        r0 = rng.integers(0, H - 6)
        data[s, r0:r0 + 6, 20:28] = rng.uniform(0.0, 1.0, (6, 8)).astype(np.float32)
    data[S - 2] = -1.0
    data[S - 1] = 1.0
    return data


def _jgrid(data):
    lead = data.shape[:-2]
    return JGridMap(jnp.asarray(data), jnp.zeros(lead + (2,), jnp.float32),
                    jnp.full(lead, 0.05, jnp.float32))


def _tgrid(data):
    lead = data.shape[:-2]
    return GridMap(torch.from_numpy(data), torch.zeros(lead + (2,)), torch.full(lead, 0.05))


def _per_map(fn, data):
    """The JAX function on each map of the batch (vmap over the GridMap)."""
    return np.asarray(jax.vmap(fn)(_jgrid(data)))


def test_entropy_matches_jax():
    p = np.random.default_rng(0).uniform(0.0, 1.0, (50, 7)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 0.5]
    np.testing.assert_allclose(target.entropy(torch.from_numpy(p)).numpy(),
                               np.asarray(jtarget.entropy(jnp.asarray(p))), atol=FIELD_ATOL)


@pytest.mark.parametrize("radius,axis", [(0, -1), (2, -1), (3, -2), (5, -2)])
def test_box_blur_matches_jax(radius, axis):
    img = np.random.default_rng(1).uniform(0.0, 0.7, (S, H, W)).astype(np.float32)
    ref = np.asarray(jtarget._box_blur_1d(jnp.asarray(img), radius, axis))
    got = target._box_blur_1d(torch.from_numpy(img), radius, axis).numpy()
    np.testing.assert_allclose(got, ref, atol=BLUR_ATOL if radius else FIELD_ATOL)


@pytest.mark.parametrize("thr", [0.65, 0.5])
def test_frontier_adjacency_matches_jax(thr):
    data = _beliefs()
    ref = _per_map(lambda g: jtarget.frontier_adjacency(g, 3, thr), data)
    got = target.frontier_adjacency(_tgrid(data), 3, thr).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(target.frontier_adjacency(_tgrid(data[1]), 3, thr).numpy(),
                                  ref[1])
    assert 0.0 < got[0].mean() < 1.0 and got[S - 2].sum() == 0.0


@pytest.mark.parametrize("r,fc", [(0, 0), (2, 0), (0, 3), (3, 3)])
def test_mutual_information_map_matches_jax(r, fc):
    data = _beliefs()
    ref = _per_map(lambda g: jtarget.mutual_information_map(g, r, fc, 0.65), data)
    got = target.mutual_information_map(_tgrid(data), r, fc, 0.65).numpy()
    np.testing.assert_allclose(got, ref, atol=BLUR_ATOL if r else FIELD_ATOL)
    assert (got[S - 1] == 0.0).all()  # fully occupied: no information anywhere


def test_sample_map_and_mi_target_values_match_jax():
    data = _beliefs()
    pts = np.array(JDomain.create(0.0, 0.0, 2.0, 2.0).sample_lattice(NS))
    vals = np.random.default_rng(2).uniform(size=(S, H, W)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda v, g: jtarget.sample_map_at(v, g, jnp.asarray(pts)))(
        jnp.asarray(vals), _jgrid(data)))
    tp = torch.from_numpy(pts).expand(S, -1, 2)
    np.testing.assert_array_equal(
        target.sample_map_at(torch.from_numpy(vals), _tgrid(data), tp).numpy(), ref)
    ref = _per_map(lambda g: jtarget.mi_target_values(g, jnp.asarray(pts), 2, 3, 0.65), data)
    got = target.mi_target_values(_tgrid(data), tp, 2, 3, 0.65).numpy()
    np.testing.assert_allclose(got, ref, atol=FIELD_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    # one map with points (N, 2)
    one = target.mi_target_values(_tgrid(data[0]), torch.from_numpy(pts), 2, 3, 0.65).numpy()
    np.testing.assert_allclose(one, ref[0], atol=FIELD_ATOL)


@pytest.mark.parametrize("r,fc", [(0, 0), (2, 3)])
def test_phik_from_grid_separable_matches_jax(r, fc):
    data = _beliefs()
    ref = _per_map(lambda g: jtarget.phik_from_grid_separable(
        g, K, NS, sensor_radius_cells=r, frontier_cells=fc), data)
    got = target.phik_from_grid_separable(_tgrid(data), K, NS, sensor_radius_cells=r,
                                          frontier_cells=fc).numpy()
    assert got.shape == (S, K, K)
    np.testing.assert_allclose(got, ref, atol=PHIK_ATOL)
    # the fully occupied map took the uniform fallback
    cosx, cosy = jbasis.axis_cos_tables(K, NS, JDomain.create(0.0, 0.0, 2.0, 2.0))
    hk = jbasis.hk_norm(K, jnp.asarray([2.0, 2.0]))
    uniform = np.asarray(jnp.sum(cosx, 0)[:, None] * jnp.sum(cosy, 0)[None, :] / (400.0 * hk))
    np.testing.assert_allclose(got[S - 1], uniform, atol=PHIK_ATOL)
    # a shared domain given explicitly, one map
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    one = target.phik_from_grid_separable(_tgrid(data[0]), K, NS, dom, r, frontier_cells=fc)
    np.testing.assert_allclose(one.numpy(), ref[0], atol=PHIK_ATOL)


@pytest.mark.parametrize("n,radius", [(7, 0), (12, 2), (9, 3), (5, 6)])
def test_blur_count_matrix_matches_jax(n, radius):
    np.testing.assert_array_equal(target.blur_count_matrix(n, radius).numpy(),
                                  np.asarray(jtarget.blur_count_matrix(n, radius)))


def test_sampling_one_hots_and_lattice_resample_match_jax():
    data = _beliefs()[0]
    jd, td = JDomain.create(0.0, 0.0, 2.0, 2.0), Domain.create(0.0, 0.0, 2.0, 2.0)
    for ns in (NS, (23, 23), (7, 31)):
        jAx, jAy = jtarget.sampling_one_hots(_jgrid(data), ns, jd)
        tAx, tAy = target.sampling_one_hots(_tgrid(data), ns, td)
        np.testing.assert_array_equal(tAx.numpy(), np.asarray(jAx))
        np.testing.assert_array_equal(tAy.numpy(), np.asarray(jAy))
        info = np.random.default_rng(4).uniform(size=(H, W)).astype(np.float32)
        ref = np.asarray(jtarget.lattice_resample(jnp.asarray(info), _jgrid(data), ns, jd))
        got = target.lattice_resample(torch.from_numpy(info), _tgrid(data), ns, td).numpy()
        np.testing.assert_allclose(got, ref, atol=FIELD_ATOL)


def test_axis_cos_tables_and_coefficients_separable_match_jax():
    jd, td = JDomain.create(0.5, -1.0, 3.0, 2.0), Domain.create(0.5, -1.0, 3.0, 2.0)
    ns = (17, 23)
    jcx, jcy = jbasis.axis_cos_tables(K, ns, jd)
    tcx, tcy = basis.axis_cos_tables(K, ns, td)
    np.testing.assert_allclose(tcx.numpy(), np.asarray(jcx), atol=FIELD_ATOL)
    np.testing.assert_allclose(tcy.numpy(), np.asarray(jcy), atol=FIELD_ATOL)
    phi = np.random.default_rng(5).uniform(size=(S,) + ns).astype(np.float32)
    phi /= phi.sum(axis=(1, 2), keepdims=True)
    ref = np.asarray(jbasis.coefficients_separable(jnp.asarray(phi), jcx, jcy,
                                                   jbasis.hk_norm(K, jd.lengths)))
    got = basis.coefficients_separable(torch.from_numpy(phi), tcx, tcy,
                                       basis.hk_norm(K, td.lengths)).numpy()
    np.testing.assert_allclose(got, ref, atol=PHIK_ATOL)
    # equal to the dense-table contraction of the same lattice values
    pts = td.sample_lattice(ns)
    D = basis.dense_table(basis.tables(pts, K, td), basis.hk_norm(K, td.lengths))
    dense = basis.coefficients_dense(torch.from_numpy(phi).reshape(S, -1), D, K).numpy()
    np.testing.assert_allclose(got, dense, atol=PHIK_ATOL)


def test_frontier_respects_occupied_threshold():
    """Cells between the configured threshold (0.5) and the default (0.65)
    are obstacles: no target mass on them, no frontier seeded from them; and
    the separable, dense and gather formulations agree with frontier_cells=2."""
    data = np.full((20, 20), -1.0, np.float32)
    data[:, :6] = 0.0
    data[:, 6:9] = 0.55  # occupied at threshold 0.5, free at 0.65
    info = target.mutual_information_map(_tgrid(data), frontier_cells=2,
                                         occupied_threshold=0.5).numpy()
    ref = np.asarray(jtarget.mutual_information_map(_jgrid(data), frontier_cells=2,
                                                    occupied_threshold=0.5))
    np.testing.assert_allclose(info, ref, atol=FIELD_ATOL)
    assert (info[:, 6:9] == 0.0).all() and (info[:, 10:] == 0.0).all()

    opts = dict(num_basis=5, grid_samples=(20, 20), occupied_threshold=0.5, mi_frontier_cells=2)
    eng = Engine(default_config("cart").replace(**opts), device="cpu")
    dom = Domain.create(0.0, 0.0, 1.0, 1.0)
    p_den = eng.phik_from_grid(_tgrid(data[None]), domain=dom)[0].numpy()
    p_sep = eng.phik_from_grid(_tgrid(data[None]))[0].numpy()
    np.testing.assert_allclose(p_den, p_sep, atol=PHIK_ATOL)
    pts = dom.sample_lattice((20, 20))
    vals = target.mi_target_values(_tgrid(data), pts, frontier_cells=2, occupied_threshold=0.5)
    ck = basis.coefficients(basis.tables(pts, 5, dom), vals, basis.hk_norm(5, dom.lengths))
    np.testing.assert_allclose(ck.numpy(), p_sep, atol=PHIK_ATOL)
    jeng = JEngine(j_default_config("cart").replace(**opts))
    jref = np.asarray(jeng.phik_from_grid(_jgrid(data[None]),
                                          domain=JDomain.create(0.0, 0.0, 1.0, 1.0)))[0]
    np.testing.assert_allclose(p_den, jref, atol=PHIK_ATOL)
