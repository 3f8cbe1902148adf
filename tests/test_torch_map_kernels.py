"""The map-cadence stages of the port's mapping loop against the JAX package:
the ray-cast reveal (``reveal_raycast_plain`` and the ``reveal_raycast``
dispatcher, the reveal kernel's plain version) and the distance field
(``DistanceField.from_grid``'s dispatcher, the EDT kernel's plain version
``edt_field_plain``) and the world rebuild with its free mask
(``Engine._world_batched``, E's plain composition ``world_plain``), on
seeded numpy maps; and the dispatch itself: CPU tensors never reach a
kernel wrapper.

The reveal decides cells by ``floor`` of an angle bin and by ``<=`` between
angles, so a last-bit difference between XLA's and ATen's atan2 / atan can
flip a cell at a bin edge: the budget is tests/test_torch_sensor.py's 0.2 %
of the window cells, the count printed. The EDT's squared distances are
exact integers, so the dispatcher equals the plain composition bit for bit;
against the JAX field the tolerance is tests/test_torch_ops.py's atol 1e-6
(the two frameworks' sqrt and division round alike, the gradient's
differences of FAR-free fields agree to the last bits).
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
from ergodic_exploration_tpu.ops import sensor as jsensor
from ergodic_exploration_tpu.ops.distance import DistanceField as JDistanceField
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import edt_kernel, reveal_kernel, sensor
from ergodic_exploration_tpu_torch.ops.distance import DistanceField, central_gradient, edt

torch.set_num_threads(2)
FLIP_BUDGET = 0.002  # share of window cells that may differ (atan2 / atan last bits)


def _maps(S, h, w, seed):
    """S truths with outer walls, an inner wall with a doorway, pillars and
    sub-threshold occupancy; beliefs half known for odd scenarios; poses
    anywhere in the map, the first at a corner and the second past an edge
    (clamped windows)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((S, h, w), np.float32)
    truth[:, [0, -1], :] = truth[:, :, [0, -1]] = 1.0
    belief = np.full((S, h, w), -1.0, np.float32)
    for s in range(S):
        c = rng.integers(w // 4, 3 * w // 4)
        truth[s, :, c] = 1.0 if s % 3 else 0.7
        d = rng.integers(2, max(3, h - 6))
        truth[s, d:d + 4, c] = 0.0
        y, x = rng.integers(2, h - 4), rng.integers(2, w - 4)
        truth[s, y:y + 3, x:x + 3] = 1.0
        if s % 2:
            belief[s, :, : w // 3] = truth[s, :, : w // 3]
    res = 0.1
    poses = np.concatenate([rng.uniform(0.02, w * res - 0.02, (S, 1)),
                            rng.uniform(0.02, h * res - 0.02, (S, 1)),
                            rng.uniform(-3, 3, (S, 1))], axis=1).astype(np.float32)
    poses[0, :2] = [0.03, 0.04]
    poses[1, :2] = [w * res + 0.2, 0.5 * h * res]
    return truth, belief, poses


def _pair(truth, belief, res=0.1):
    """(JAX truth, JAX belief, port truth, port belief)."""
    lead = truth.shape[:-2]

    def j(d):
        return JGridMap(jnp.asarray(d), jnp.zeros(lead + (2,), jnp.float32),
                        jnp.full(lead, res, jnp.float32))

    def t(d):
        return GridMap(torch.from_numpy(d.copy()), torch.zeros(lead + (2,)),
                       torch.full(lead, res))

    return j(truth), j(belief), t(truth), t(belief)


# (S, h, w, sensor range (m), n_bins): a window that fits, one wider than the
# map (P = min(window, h, w)), few bins
REVEAL_CASES = {
    "window_in_map": (6, 50, 44, 1.2, 256),
    "map_under_window": (4, 16, 20, 2.0, 256),
    "n_bins_97": (5, 40, 40, 1.5, 97),
}


@pytest.mark.parametrize("case", list(REVEAL_CASES))
def test_reveal_plain_and_dispatcher_match_jax(case):
    S, h, w, rng_m, n_bins = REVEAL_CASES[case]
    truth, belief, poses = _maps(S, h, w, seed=h * w + n_bins)
    jt, jb, tt, tb = _pair(truth, belief)
    win = sensor.raycast_window_cells(rng_m, 0.1)
    P = min(win, h, w)
    ref = np.asarray(jax.vmap(lambda b, t, x: jsensor.reveal_raycast(
        b, t, x, rng_m, win, n_bins=n_bins))(jb, jt, jnp.asarray(poses)).data)
    x = torch.from_numpy(poses)
    plain = sensor.reveal_raycast_plain(tb, tt, x, rng_m, win, n_bins, chunk=3).data
    got = sensor.reveal_raycast(tb, tt, x, rng_m, win, n_bins).data
    assert torch.equal(plain, got)  # the dispatcher takes the plain version on the CPU
    bad = int((got.numpy() != ref).sum())
    print(f"{case}: {bad} of {S * P * P} window cells differ from the JAX reveal")
    assert bad <= FLIP_BUDGET * S * P * P
    assert ((got.numpy() >= 0) & (belief < 0)).any(axis=(1, 2)).sum() >= S - 2  # new cells
    # one map with one pose gives its row of the batch
    one = sensor.reveal_raycast(GridMap(tb.data[1], tb.origin[1], tb.resolution[1]),
                                GridMap(tt.data[1], tt.origin[1], tt.resolution[1]),
                                x[1], rng_m, win, n_bins).data
    assert torch.equal(one, got[1])


def _fields(occ_data, res):
    jf = jax.vmap(lambda d, r: JDistanceField.from_grid(
        JGridMap(d, jnp.zeros(2, jnp.float32), r)))(jnp.asarray(occ_data), jnp.asarray(res))
    tf = DistanceField.from_grid(GridMap(torch.from_numpy(occ_data),
                                         torch.zeros(occ_data.shape[0], 2),
                                         torch.from_numpy(res)))
    return jf, tf


@pytest.mark.parametrize("h,w", [(40, 40), (17, 23), (30, 12)])
def test_from_grid_dispatcher_is_the_plain_composition_and_matches_jax(h, w):
    truth, belief, _ = _maps(5, h, w, seed=h + w)
    data = np.concatenate([truth, belief, np.full((1, h, w), -1.0, np.float32),
                           np.ones((1, h, w), np.float32)])  # an empty map, a full one
    res = np.linspace(0.05, 0.1, data.shape[0]).astype(np.float32)
    jf, tf = _fields(data, res)
    occ = torch.from_numpy(data) >= 0.65
    d = edt(occ, torch.from_numpy(res))
    gx, gy = central_gradient(d, torch.from_numpy(res))
    assert torch.equal(tf.dist, d) and torch.equal(tf.grad, torch.stack([gx, gy], dim=-1))
    np.testing.assert_allclose(tf.dist.numpy(), np.asarray(jf.dist), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf.grad), rtol=0.0, atol=1e-6)
    assert (tf.dist[-2] == 1.0e6).all() and (tf.grad[-2] == 0).all()
    assert (tf.dist[-1] == 0).all()
    # one map (no leading axis) gives its row of the batch
    one = DistanceField.from_grid(GridMap(torch.from_numpy(data[2]), torch.zeros(2),
                                          torch.tensor(res[2])))
    assert torch.equal(one.dist, tf.dist[2]) and torch.equal(one.grad, tf.grad[2])


@pytest.mark.parametrize("domain", ["maps_extent", "wider_domain"])
def test_world_batched_matches_jax_world_one(domain):
    """``Engine._world_batched`` on the CPU (E's plain composition,
    ``edt_kernel.world_plain``) against the JAX engine's
    ``jax.vmap(_world_one)`` on the same maps (each its own origin and
    resolution, NaN cells among them) over their extents and over a wider
    domain whose lattice points clamp to the maps' edges: the free mask
    exactly, the distance field within atol 1e-6."""
    S, h, w = 5, 30, 36
    truth, belief, _ = _maps(S, h, w, seed=11)
    data = np.concatenate([truth[:2], belief[2:]])
    data[3, 4, 5] = data[4, 0, 0] = np.nan
    origin = np.array([[0.0, 0.0], [0.3, -0.2], [-1.0, 0.5], [0.05, 0.05], [2.0, 1.0]], np.float32)
    res = np.linspace(0.05, 0.1, S).astype(np.float32)
    ext = np.stack([w * res, h * res], axis=-1)
    if domain == "wider_domain":
        d_origin, d_lengths = origin - 0.37, ext + 0.9
    else:
        d_origin, d_lengths = origin, ext
    opts = dict(grid_samples=(40, 27))
    je = JEngine(j_default_config("cart").replace(**opts))
    te = Engine(default_config("cart").replace(**opts), device="cpu")
    jw = jax.vmap(je._world_one)(JGridMap(jnp.asarray(data), jnp.asarray(origin), jnp.asarray(res)),
                                 JDomain(jnp.asarray(d_origin), jnp.asarray(d_lengths)))
    tw = te._world_batched(GridMap(torch.from_numpy(data), torch.from_numpy(origin),
                                   torch.from_numpy(res)),
                           Domain(torch.from_numpy(d_origin), torch.from_numpy(d_lengths)))
    free = tw.free_mask.numpy()
    np.testing.assert_array_equal(free, np.asarray(jw.free_mask))
    assert free.shape == (S, 40 * 27) and 0 < free.sum() < free.size
    assert free[3].sum() < free[3].size  # the NaN cell is not free
    np.testing.assert_allclose(tw.dist.dist.numpy(), np.asarray(jw.dist.dist), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(tw.dist.grad.numpy(), np.asarray(jw.dist.grad), rtol=0.0, atol=1e-6)
    dist, grad, mask = edt_kernel.world_plain(
        GridMap(torch.from_numpy(data), torch.from_numpy(origin), torch.from_numpy(res)),
        Domain(torch.from_numpy(d_origin), torch.from_numpy(d_lengths)), 0.65, (40, 27))
    assert torch.equal(tw.dist.dist, dist) and torch.equal(tw.dist.grad, grad)
    assert torch.equal(tw.free_mask, mask)


def test_cpu_tensors_never_reach_a_kernel_wrapper(monkeypatch):
    """On the CPU both dispatchers run the plain versions: a wrapper that
    would launch raises here, and the launch counts stay 0."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(reveal_kernel.RevealRaycast, "__call__", refuse)
    monkeypatch.setattr(edt_kernel.EdtField, "__call__", refuse)
    monkeypatch.setattr(edt_kernel.EdtField, "world", refuse)
    reveal_kernel.R.reset_launches()
    edt_kernel.E.reset_launches()
    truth, belief, poses = _maps(3, 30, 30, seed=3)
    _, _, tt, tb = _pair(truth, belief)
    win = sensor.raycast_window_cells(1.5, 0.1)
    out = sensor.reveal_raycast(tb, tt, torch.from_numpy(poses), 1.5, win)
    DistanceField.from_grid(out)
    DistanceField.from_grid(GridMap(out.data[0], out.origin[0], out.resolution[0]))
    edt_kernel.world_fields(out, out.domain(), 0.65, (20, 20))
    assert not any(reveal_kernel.R.launches.values())
    assert not any(edt_kernel.E.launches.values())
    # and a CUDA-only wrapper refuses a CPU tensor outright
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        edt_kernel.E(tb.data, tb.resolution, 0.65)
    with pytest.raises(ValueError, match="CUDA"):
        edt_kernel.E.world(tb.data, tb.resolution, 0.65, tb.origin, tb.origin,
                           tb.domain().lengths, torch.zeros(20), torch.zeros(20))
    with pytest.raises(ValueError, match="CUDA"):
        reveal_kernel.R(tb.data, tt.data, tb.origin, tb.resolution, torch.from_numpy(poses),
                        sensor.bin_centers(256, "cpu"), 1.5, win, 256, 0.65)
