"""The port's ops against the JAX package's, on the CPU at small sizes.

Inputs are made with numpy from a seed and fed to both. The JAX functions
are per-scenario and batched here with ``jax.vmap``; the port's take the
scenario axis first. Tolerances: float32 results rtol 1e-5 (atol 1e-6 for
values near zero), integer codes and DWA picks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.models import make_model as j_make_model
from ergodic_exploration_tpu.ops import barrier as jbarrier
from ergodic_exploration_tpu.ops import basis as jbasis
from ergodic_exploration_tpu.ops import collision as jcollision
from ergodic_exploration_tpu.ops import dwa as jdwa
from ergodic_exploration_tpu.ops import integrator as jint
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu.ops.distance import DistanceField as JDistanceField
from ergodic_exploration_tpu.ops.patch import extract_patch as j_extract_patch
from ergodic_exploration_tpu.utils.numerics import normalize_angle as j_normalize_angle
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.models import make_model
from ergodic_exploration_tpu_torch.ops import barrier as tbarrier
from ergodic_exploration_tpu_torch.ops import basis as tbasis
from ergodic_exploration_tpu_torch.ops import collision as tcollision
from ergodic_exploration_tpu_torch.ops import dwa as tdwa
from ergodic_exploration_tpu_torch.ops import integrator as tint
from ergodic_exploration_tpu_torch.ops import target as ttarget
from ergodic_exploration_tpu_torch.ops.distance import DistanceField, edt
from ergodic_exploration_tpu_torch.ops.patch import extract_patch
from ergodic_exploration_tpu_torch.utils.numerics import normalize_angle

torch.set_num_threads(2)
S = 8


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _poses(seed=0, lo=0.4, hi=2.6):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(lo, hi, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                          axis=1).astype(np.float32)


def _world():
    """A 60 x 60 map of a 3 m domain with a wall through the middle, both
    packages' distance fields and per-scenario (batched) domains."""
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    jg = JGridMap.create(data, 0.0, 0.0, 0.05)
    tg = GridMap.create(data, 0.0, 0.0, 0.05)
    jf = JDistanceField.from_grid(jg)
    tf = DistanceField.from_grid(tg)
    jfb = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape), jf)
    tfb = DistanceField(*(t.expand(S, *t.shape).contiguous() for t in tf))
    jdom = JDomain.create(0.0, 0.0, 3.0, 3.0)
    tdom = Domain(torch.zeros(S, 2), torch.full((S, 2), 3.0))
    return jf, tf, jfb, tfb, jdom, tdom


def test_normalize_angle_bit_exact():
    k = np.arange(-4, 5, dtype=np.float32)
    th = np.concatenate([np.float32(np.pi) * np.array([1, -1], np.float32),
                         np.float32(2 * np.pi) * k, np.float32(np.pi) * (2 * k + 1),
                         np.random.default_rng(0).uniform(-30, 30, 256).astype(np.float32)])
    th = np.concatenate([th, np.nextafter(th, np.float32(np.inf)),
                         np.nextafter(th, np.float32(-np.inf))])
    ref = np.asarray(j_normalize_angle(jnp.asarray(th)))
    got = normalize_angle(T(th)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_grid_matches():
    rng = np.random.default_rng(11)
    data = rng.choice(np.float32([-1.0, 0.0, 0.3, 0.9, 1.0]), size=(S, 20, 24))
    origin = rng.uniform(-1, 1, (S, 2)).astype(np.float32)
    res = rng.uniform(0.04, 0.06, S).astype(np.float32)
    jg = JGridMap(jnp.asarray(data), jnp.asarray(origin), jnp.asarray(res))
    tg = GridMap(T(data), T(origin), T(res))
    jd = jax.vmap(lambda g: g.domain())(jg)
    td = tg.domain()
    close(td.lengths, jd.lengths, rtol=0.0, atol=0.0)
    pts = jax.vmap(lambda d: d.sample_lattice((7, 9)))(jd)
    close(td.sample_lattice((7, 9)), pts, rtol=0.0, atol=0.0)
    equal(tg.occupancy_at(T(pts)), jax.vmap(lambda g, p: g.occupancy_at(p))(jg, pts))
    equal(tg.prob(), jg.prob())
    equal(tg.occupied(0.65), jg.occupied(0.65))
    q = np.asarray(pts) + rng.uniform(-0.2, 0.2, np.shape(pts)).astype(np.float32)
    equal(td.contains(T(q)), jax.vmap(lambda d, p: d.contains(p))(jd, jnp.asarray(q)))


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_models_match(model):
    jm, tm = j_make_model(j_default_config(model)), make_model(default_config(model))
    rng = np.random.default_rng(1)
    x = _poses(1)
    u = rng.uniform(-6, 6, (S, tm.nu)).astype(np.float32)
    tw = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    for name in ("f", "A", "B"):
        close(getattr(tm, name)(T(x), T(u)), getattr(jm, name)(jnp.asarray(x), jnp.asarray(u)))
    close(tm.twist(T(u)), jm.twist(jnp.asarray(u)))
    close(tm.from_twist(T(tw)), jm.from_twist(jnp.asarray(tw)))


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_rollout_costate_and_arcs_match(model):
    cfg = default_config(model)
    jm, tm = j_make_model(j_default_config(model)), make_model(cfg)
    rng = np.random.default_rng(2)
    x = _poses(2)
    U = rng.uniform(-6, 6, (S, 20, tm.nu)).astype(np.float32)
    X_ref = jax.vmap(lambda a, b: jint.rollout(jm, a, b, 0.1))(jnp.asarray(x), jnp.asarray(U))
    close(tint.rollout(tm, T(x), T(U), 0.1), X_ref)
    As = rng.normal(size=(S, 20, 3, 3)).astype(np.float32)
    gs = rng.normal(size=(S, 20, 3)).astype(np.float32)
    rho_ref = jax.vmap(lambda a, g: jint.costate_solve(a, g, 0.1))(jnp.asarray(As), jnp.asarray(gs))
    close(tint.costate_solve(T(As), T(gs), 0.1), rho_ref)
    tw = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    tw[0, 2] = 0.0  # the small-omega series branch
    ts = 0.1 * np.arange(1, 11, dtype=np.float32)
    ref = jax.vmap(lambda a, b: jint.constant_twist_poses(a, b, jnp.asarray(ts)))(
        jnp.asarray(x), jnp.asarray(tw))
    close(tint.constant_twist_poses(T(x), T(tw), T(ts)), ref)


def test_basis_matches():
    K = 6
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 3, (S, 20, 2)).astype(np.float32)
    jdom = JDomain.create(0.0, 0.0, 3.0, 2.5)
    tdom = Domain(torch.zeros(S, 2), T(np.tile(np.float32([3.0, 2.5]), (S, 1))))
    jtbl = jax.vmap(lambda p: jbasis.tables(p, K, jdom))(jnp.asarray(pts))
    ttbl = tbasis.tables(T(pts), K, tdom)
    for a, b in zip(ttbl, jtbl):
        close(a, b)
    jhk = jbasis.hk_norm(K, jdom.lengths)
    thk = tbasis.hk_norm(K, tdom.lengths)
    close(thk, np.broadcast_to(np.asarray(jhk), (S, K, K)))
    close(tbasis.lambda_weights(K), jbasis.lambda_weights(K))
    w = rng.uniform(0, 1, (S, 20)).astype(np.float32)
    ck_ref = jax.vmap(lambda t, ww: jbasis.coefficients(t, ww, jhk))(jtbl, jnp.asarray(w))
    ck = tbasis.coefficients(ttbl, T(w), thk)
    close(ck, ck_ref)
    close(tbasis.cos_tables(T(pts), K, tdom)[1], jtbl.Cy)
    phik = rng.uniform(-0.2, 0.2, (S, K, K)).astype(np.float32)
    lam_j, lam_t = jbasis.lambda_weights(K), tbasis.lambda_weights(K)
    close(tbasis.ergodic_metric(ck, T(phik), lam_t),
          jax.vmap(lambda c, p: jbasis.ergodic_metric(c, p, lam_j))(ck_ref, jnp.asarray(phik)))
    M = rng.uniform(20, 120, S).astype(np.float32)
    g_ref = jax.vmap(lambda t, c, p, m: jbasis.ergodic_gradient(t, c, p, lam_j, jhk, m))(
        jtbl, ck_ref, jnp.asarray(phik), jnp.asarray(M))
    close(tbasis.ergodic_gradient(ttbl, ck, T(phik), lam_t, thk, T(M)), g_ref, atol=1e-5)
    lattice = jdom.sample_lattice((30, 25))
    shared = Domain(torch.zeros(2), T(np.float32([3.0, 2.5])))
    tlat = shared.sample_lattice((30, 25))
    close(tlat, lattice)
    D_ref = jbasis.dense_table(jbasis.tables(lattice, K, jdom), jhk)
    D = tbasis.dense_table(tbasis.tables(tlat, K, shared), tbasis.hk_norm(K, shared.lengths))
    close(D, D_ref)


def test_gmm_values_match():
    rng = np.random.default_rng(4)
    pts = np.asarray(JDomain.create(0.0, 0.0, 3.0, 3.0).sample_lattice((30, 30)))
    means = rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    covs[:, 1, 0, 1] = covs[:, 1, 1, 0] = 0.05
    w = rng.uniform(0.5, 1.5, (S, 2)).astype(np.float32)
    mask = (rng.uniform(size=(S, 900)) > 0.2).astype(np.float32)
    jg = jtarget.GaussianMixture.create(means, covs, w)
    tg = ttarget.GaussianMixture.create(means, covs, w)
    ref = jax.vmap(lambda g: jtarget.gmm_eval(jnp.asarray(pts), g))(jg)
    close(ttarget.gmm_eval(T(pts), tg), ref, atol=1e-7)
    ref = jax.vmap(lambda g, m: jtarget.gmm_target_values(jnp.asarray(pts), g, m))(
        jg, jnp.asarray(mask))
    close(ttarget.gmm_target_values(T(pts), tg, T(mask)), ref, atol=1e-9)
    zero = np.zeros((S, 900), np.float32)  # degenerate: uniform over the mask
    close(ttarget.normalize_phi(T(zero), T(mask)),
          jax.vmap(jtarget.normalize_phi)(jnp.asarray(zero), jnp.asarray(mask)), atol=1e-9)


def test_distance_field_matches():
    jf, tf, *_ = _world()
    close(tf.dist, jf.dist, rtol=0.0, atol=1e-6)
    close(tf.grad, jf.grad, rtol=0.0, atol=1e-6)
    occ = np.random.default_rng(5).uniform(size=(7, 20, 20)) > 0.97
    occ[3] = False  # an empty map: FAR everywhere
    res = np.full(7, 0.05, np.float32)
    ref = jax.vmap(lambda o, r: JDistanceField.from_grid(
        JGridMap(jnp.asarray(o, jnp.float32), jnp.zeros(2), r)).dist)(
            jnp.asarray(occ), jnp.asarray(res))
    close(edt(T(occ), T(res), chunk=3), ref, rtol=0.0, atol=1e-6)


def test_patch_and_queries_match():
    jf, tf, jfb, tfb, *_ = _world()
    x = _poses(6, lo=0.1, hi=2.9)  # near the map edges too (clamped patches)
    jp = jax.vmap(lambda f, c: j_extract_patch(f, c, 24))(jfb, jnp.asarray(x[:, :2]))
    tp = extract_patch(tfb, T(x[:, :2]), 24)
    equal(tp.dist, jp.dist)
    equal(tp.start, jp.start)
    close(tp.grad, jp.grad, rtol=0.0, atol=1e-6)
    q = (x[:, None, :2] + np.random.default_rng(7).uniform(-0.5, 0.5, (S, 30, 2))).astype(
        np.float32)
    d_ref, g_ref = jax.vmap(lambda p, qq: p.query(qq))(jp, jnp.asarray(q))
    d, g = tp.query(T(q))
    close(d, d_ref)
    close(g, g_ref, atol=1e-5)
    crop_ref = jax.vmap(lambda p: p.center_crop(16))(jp)
    crop = tp.center_crop(16)
    equal(crop.dist, crop_ref.dist)
    equal(crop.query_dist(T(q)), jax.vmap(lambda p, qq: p.query_dist(qq))(crop_ref, jnp.asarray(q)))


def _query_fields():
    """Distance fields of 30 x 40 maps at origin (0.3, -0.2), 0.05 m a cell:
    a map with a block, an empty map (FAR everywhere), and a batch of three
    (two blocks elsewhere, one empty), in both packages; the JAX batch is
    ``from_grid`` vmapped over the maps."""
    data = np.zeros((4, 30, 40), np.float32)
    data[0, 10:14, 5:25] = 1.0
    data[2, 20:26, 30:34] = 1.0
    data[3, 0:3, 0:40] = 1.0
    fields = {}
    for name, d in (("block", data[0]), ("empty", data[1])):
        fields[name] = (JDistanceField.from_grid(JGridMap.create(d, 0.3, -0.2, 0.05)),
                        DistanceField.from_grid(GridMap.create(d, 0.3, -0.2, 0.05)))
    b = data[1:]
    origin = np.tile(np.float32([0.3, -0.2]), (3, 1))
    res = np.full(3, 0.05, np.float32)
    jb = jax.vmap(lambda m, o, r: JDistanceField.from_grid(JGridMap(m, o, r)))(
        jnp.asarray(b), jnp.asarray(origin), jnp.asarray(res))
    fields["batch"] = (jb, DistanceField.from_grid(GridMap(T(b), T(origin), T(res))))
    return fields


def _query_points(n, seed):
    """(n, 2) world points over the 30 x 40 map at (0.3, -0.2): inside it,
    on cell edges, and outside it on every side."""
    rng = np.random.default_rng(seed)
    x0, y0, r = 0.3, -0.2, 0.05
    inside = np.stack([rng.uniform(x0, x0 + 40 * r, n), rng.uniform(y0, y0 + 30 * r, n)], -1)
    edges = np.stack([x0 + r * rng.integers(0, 41, n), y0 + r * rng.integers(0, 31, n)], -1)
    out = inside.copy()
    side = np.arange(n) % 4
    out[side == 0, 0] = x0 - rng.uniform(0.01, 1.0, (side == 0).sum())
    out[side == 1, 0] = x0 + 40 * r + rng.uniform(0.01, 1.0, (side == 1).sum())
    out[side == 2, 1] = y0 - rng.uniform(0.01, 1.0, (side == 2).sum())
    out[side == 3, 1] = y0 + 30 * r + rng.uniform(0.01, 1.0, (side == 3).sum())
    return np.concatenate([inside, edges, out]).astype(np.float32)


@pytest.mark.parametrize("method", ["query", "query_dist"])
@pytest.mark.parametrize("field", ["block", "empty"])
def test_distance_field_queries_match(method, field):
    """DistanceField.query / query_dist on a whole field (JAX
    ops/distance.py:97-147): nearest-cell distance exactly, the bilinear
    distance and gradient within 1e-6; on a batch of three fields against
    ``jax.vmap`` of the JAX method."""
    fields = _query_fields()
    for jf, tf, q in ((*fields[field], _query_points(24, 3).reshape(6, 12, 2)),
                      (*fields["batch"], _query_points(24, 4).reshape(3, 24, 2))):
        batched = tf.dist.dim() == 3
        call = jax.vmap(lambda f, p: getattr(f, method)(p)) if batched else \
            (lambda f, p: getattr(f, method)(p))
        ref = call(jf, jnp.asarray(q))
        got = getattr(tf, method)(T(q))
        if method == "query_dist":
            equal(got, ref)
        else:
            close(got[0], ref[0], rtol=0.0, atol=1e-6)
            close(got[1], ref[1], rtol=0.0, atol=1e-6)
        if field == "empty" and not batched:
            assert ((got if method == "query_dist" else got[0]) >= 0.9e6).all()


@pytest.mark.parametrize("maps", ["per_scenario", "shared"])
def test_barrier_and_collision_on_a_whole_field(maps):
    """barrier and check_pose given a whole DistanceField (per-scenario
    fields, or one field shared by every scenario) against the JAX functions
    on the same field."""
    fields = _query_fields()
    jf, tf = fields["batch"] if maps == "per_scenario" else fields["block"]
    q = _query_points(24, 5).reshape(3, 24, 2)
    cfg, jcfg = default_config("cart"), j_default_config("cart")
    jdom = JDomain.create(0.3, -0.2, 2.0, 1.5)
    tdom = Domain(torch.tensor([[0.3, -0.2]]).expand(3, 2), torch.tensor([[2.0, 1.5]]).expand(3, 2))
    axes = (0, 0) if maps == "per_scenario" else (None, 0)
    v_ref, g_ref = jax.vmap(lambda f, p: jbarrier.barrier(p, jdom, f, jcfg), in_axes=axes)(
        jf, jnp.asarray(q))
    v, g = tbarrier.barrier(T(q), tdom, tf, cfg)
    close(v, v_ref)
    close(g, g_ref)
    code_ref = jax.vmap(lambda f, p: jcollision.check_pose(p, jdom, f, cfg.boundary_radius,
                                                           cfg.d_safe), in_axes=axes)(
        jf, jnp.asarray(q))
    code = tcollision.check_pose(T(q), tdom, tf, cfg.boundary_radius, cfg.d_safe)
    equal(code, code_ref)
    assert {0, 2} <= set(code.flatten().tolist())


def test_barrier_matches():
    jf, tf, jfb, tfb, jdom, tdom = _world()
    cfg = default_config("cart")
    x = _poses(8, lo=0.02, hi=2.98)
    jp = jax.vmap(lambda f, c: j_extract_patch(f, c, 24))(jfb, jnp.asarray(x[:, :2]))
    tp = extract_patch(tfb, T(x[:, :2]), 24)
    q = (x[:, None, :2] + np.random.default_rng(9).uniform(-0.3, 0.3, (S, 20, 2))).astype(
        np.float32)
    v_ref, g_ref = jax.vmap(lambda p, qq: jbarrier.barrier(qq, jdom, p, j_default_config("cart")))(
        jp, jnp.asarray(q))
    v, g = tbarrier.barrier(T(q), tdom, tp, cfg)
    close(v, v_ref)
    close(g, g_ref, atol=1e-5)


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_collision_codes_and_dwa_exact(model):
    jf, tf, jfb, tfb, jdom, tdom = _world()
    jcfg, cfg = j_default_config(model), default_config(model)
    jm, tm = j_make_model(jcfg), make_model(cfg)
    rng = np.random.default_rng(10)
    x = _poses(10)
    x[:4, 1] = 1.2  # just below the wall (y 1.4 .. 1.6), heading at it
    x[:4, 2] = np.pi / 2
    u = rng.uniform(-6, 6, (S, tm.nu)).astype(np.float32)
    vb = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    if model == "cart":
        vb[:, 1] = 0.0
    jp = jax.vmap(lambda f, c: j_extract_patch(f, c, cfg.patch_cells).center_crop(16))(
        jfb, jnp.asarray(x[:, :2]))
    tp = extract_patch(tfb, T(x[:, :2]), cfg.patch_cells).center_crop(16)
    code_ref = jax.vmap(lambda xx, uu, p: jcollision.validate_control(jm, xx, uu, jdom, p, jcfg))(
        jnp.asarray(x), jnp.asarray(u), jp)
    code = tcollision.validate_control(tm, T(x), T(u), tdom, tp, cfg)
    equal(code, code_ref)
    assert (code.numpy() == tcollision.CRASH).any()
    u_ref, f_ref = jax.vmap(lambda xx, v, uu, p: jdwa.dwa_control(jm, xx, v, uu, jdom, p, jcfg))(
        jnp.asarray(x), jnp.asarray(vb), jnp.asarray(u), jp)
    ud, feas = tdwa.dwa_control(tm, T(x), T(vb), T(u), tdom, tp, cfg)
    equal(ud, u_ref)
    equal(feas, f_ref)
