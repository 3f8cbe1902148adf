"""ops/sensor.py of the port against the JAX package, cell for cell: the disc
reveal, the occlusion-aware ray-cast reveal (one map and batched), the
window size and ``fraction_known``, on the worlds of tests/test_sensor.py and
on seeded poses; and the reveal's own properties (blocks behind walls,
monotone, idempotent, known cells equal the truth).

The ray-cast reveal decides cells by ``floor`` of an angle bin and by
``<=`` between angles, so a last-bit difference between XLA's and ATen's
atan2 / atan can flip a cell at a bin edge. The budget is 0.2 % of the window
cells; the count is printed (0 on the cases here) and the cells that differ
must lie inside the disc reveal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops import sensor as jsensor
from ergodic_exploration_tpu_torch.grid import GridMap
from ergodic_exploration_tpu_torch.ops import sensor

torch.set_num_threads(2)
FLIP_BUDGET = 0.002  # share of window cells that may differ (atan2 / atan last bits)


def _world(wall=True):
    """5 m x 5 m, 50 x 50 cells (res 0.1); vertical wall x = 2.45..2.55 m
    spanning y = 1..4 m (tests/test_sensor.py::_world)."""
    data = np.zeros((50, 50), np.float32)
    if wall:
        data[10:40, 24:26] = 1.0
    return data


def _pair(data, belief=None):
    """(JAX truth, JAX belief, port truth, port belief) for truth ``data``."""
    belief = np.full_like(data, -1.0) if belief is None else belief
    lead = data.shape[:-2]
    j = lambda d: JGridMap(jnp.asarray(d), jnp.zeros(lead + (2,), jnp.float32),  # noqa: E731
                           jnp.full(lead, 0.1, jnp.float32))
    t = lambda d: GridMap(torch.from_numpy(d.copy()), torch.zeros(lead + (2,)),  # noqa: E731
                          torch.full(lead, 0.1))
    return j(data), j(belief), t(data), t(belief)


def _flips(got, ref, window_cells, n=1):
    bad = int((got != ref).sum())
    print(f"cells that differ from the JAX reveal: {bad} of {n * window_cells ** 2} window cells")
    assert bad <= FLIP_BUDGET * n * window_cells ** 2
    return bad


def test_window_size_and_fraction_known_match_jax():
    for rng_m, res in ((1.5, 0.05), (2.0, 0.1), (1.2, 0.1), (0.5, 0.05), (0.33, 0.07)):
        assert sensor.raycast_window_cells(rng_m, res) == jsensor.raycast_window_cells(rng_m, res)
    assert sensor.raycast_window_cells(1.5, 0.05) == 63
    data = _world()
    data[:20] = -1.0
    jt, _, tt, _ = _pair(data)
    # the mean divides in one package and multiplies by 1/n in the other: one ulp
    np.testing.assert_allclose(float(sensor.fraction_known(tt)),
                               float(jsensor.fraction_known(jt)), atol=1e-6)
    np.testing.assert_allclose(float(sensor.fraction_known(tt)), 0.6, atol=1e-6)


@pytest.mark.parametrize("pose", [[1.5, 2.5, 0.0], [0.05, 4.9, 1.0], [3.3, 0.4, -2.0]])
def test_disc_reveal_matches_jax(pose):
    jt, jb, tt, tb = _pair(_world())
    ref = np.asarray(jsensor.reveal(jb, jt, jnp.asarray(pose), 2.0).data)
    got = sensor.reveal(tb, tt, torch.tensor(pose), 2.0).data.numpy()
    np.testing.assert_array_equal(got, ref)
    if pose[0] == 1.5:
        assert got[25, 32] >= 0.0  # the disc model sees through the wall


def test_raycast_blocks_behind_walls_and_matches_disc_in_open_space():
    jt, jb, tt, tb = _pair(_world())
    pose, rng_m = [1.5, 2.5, 0.0], 2.0
    win = sensor.raycast_window_cells(rng_m, 0.1)
    got = sensor.reveal_raycast(tb, tt, torch.tensor(pose), rng_m, win).data.numpy()
    ref = np.asarray(jsensor.reveal_raycast(jb, jt, jnp.asarray(pose), rng_m, win).data)
    _flips(got, ref, win)
    assert got[25, 20] == 0.0 and got[25, 24] == 1.0  # in front: free; the wall: occupied
    assert got[25, 30] == -1.0 and got[25, 32] == -1.0 and got[20, 30] == -1.0  # shadow
    assert got[25, 48] == -1.0  # out of range
    disc = sensor.reveal(tb, tt, torch.tensor(pose), rng_m).data.numpy()
    assert not np.any((got >= 0) & ~(disc >= 0)) and (got >= 0).sum() < (disc >= 0).sum()
    # open space: ray cast == disc exactly
    _, _, to, bo = _pair(_world(wall=False))
    np.testing.assert_array_equal(
        sensor.reveal_raycast(bo, to, torch.tensor(pose), rng_m, win).data.numpy(),
        sensor.reveal(bo, to, torch.tensor(pose), rng_m).data.numpy())


def test_raycast_is_monotone_and_idempotent():
    _, _, tt, tb = _pair(_world())
    win = sensor.raycast_window_cells(1.5, 0.1)
    p1, p2 = torch.tensor([1.0, 2.0, 0.0]), torch.tensor([1.5, 3.0, 0.0])
    b1 = sensor.reveal_raycast(tb, tt, p1, 1.5, win)
    b12 = sensor.reveal_raycast(b1, tt, p2, 1.5, win)
    k1, k12 = b1.data.numpy() >= 0, b12.data.numpy() >= 0
    assert not np.any(k1 & ~k12)  # nothing un-revealed
    b11 = sensor.reveal_raycast(b1, tt, p1, 1.5, win)
    np.testing.assert_array_equal(b11.data.numpy(), b1.data.numpy())
    assert np.array_equal(b12.data.numpy()[k12], tt.data.numpy()[k12])


def _seeded_batch(S=12, seed=9):
    """Distinct truths (a wall and a pillar each, probabilities in the wall of
    every third map), half-known beliefs for some, poses anywhere in the map
    (near the border too, where the window is edge-clamped)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((S, 50, 50), np.float32)
    belief = np.full((S, 50, 50), -1.0, np.float32)
    for s in range(S):
        r, c = rng.integers(5, 40), rng.integers(3, 25)
        truth[s, r:r + 2, c:c + 20] = 0.7 if s % 3 == 0 else 1.0
        pr, pc = rng.integers(3, 44, 2)
        truth[s, pr:pr + 4, pc:pc + 4] = 1.0
        if s % 2:
            belief[s, :, :20] = truth[s, :, :20]
    poses = np.concatenate([rng.uniform(0.02, 4.98, (S, 2)), rng.uniform(-3, 3, (S, 1))],
                           axis=1).astype(np.float32)
    poses[0, :2] = [0.03, 0.04]  # a corner: rows and columns clamp
    return truth, belief, poses


@pytest.mark.parametrize("sensor_range,thr", [(1.2, 0.65), (2.0, 0.65), (1.2, 0.75)])
def test_raycast_batched_matches_jax(sensor_range, thr):
    truth, belief, poses = _seeded_batch()
    S = truth.shape[0]
    jt, jb, tt, tb = _pair(truth, belief)
    win = sensor.raycast_window_cells(sensor_range, 0.1)
    ref = np.asarray(jax.jit(jax.vmap(lambda b, t, x: jsensor.reveal_raycast(
        b, t, x, sensor_range, win, occupied_threshold=thr)))(jb, jt, jnp.asarray(poses)).data)
    got = sensor.reveal_raycast(tb, tt, torch.from_numpy(poses), sensor_range, win,
                                occupied_threshold=thr, chunk=5).data.numpy()
    _flips(got, ref, win, S)
    assert ((got >= 0) & (belief < 0)).any(axis=(1, 2)).sum() >= S - 2  # new cells were seen
    if thr == 0.75:  # the 0.7 walls do not block: more is seen than at 0.65
        lo = sensor.reveal_raycast(tb, tt, torch.from_numpy(poses), sensor_range, win,
                                   occupied_threshold=0.65).data.numpy()
        assert (got[::3] >= 0).sum() > (lo[::3] >= 0).sum()
    # chunking and batching change nothing: each scenario alone gives its row
    for s in (0, 4, S - 1):
        one = sensor.reveal_raycast(GridMap(tb.data[s], tb.origin[s], tb.resolution[s]),
                                    GridMap(tt.data[s], tt.origin[s], tt.resolution[s]),
                                    torch.from_numpy(poses[s]), sensor_range, win,
                                    occupied_threshold=thr).data.numpy()
        np.testing.assert_array_equal(one, got[s])
    # the disc reveal, batched
    ref_d = np.asarray(jax.vmap(lambda b, t, x: jsensor.reveal(b, t, x, sensor_range))(
        jb, jt, jnp.asarray(poses)).data)
    np.testing.assert_array_equal(
        sensor.reveal(tb, tt, torch.from_numpy(poses), sensor_range).data.numpy(), ref_d)
    assert not np.any((got >= 0) & ~(ref_d >= 0))
