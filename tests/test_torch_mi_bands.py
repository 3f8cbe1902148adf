"""K3's row-band form: the band plan (pure Python) and a plain PyTorch
band-wise evaluation that mirrors what ``k3_phik_band`` + ``k3_finish`` of
csrc/mi_kernel.cu compute (a band's rows with a halo of max(r, fc) rows cut at
the map's edges, box sums clamped at the MAP's edge, an unnormalized (K, K)
partial per band, the partials added in band order, then the normalization).

Tolerances: the band-wise evaluation adds the same products as
``phik_from_grid_plain`` with the sum over rows split per band, so it is held
to 2e-6; against the JAX package's dense path it is held to that package's own
budget for its kernel (rtol 2e-4, atol 2e-5, tests/test_mi_kernel.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import mi_kernel as mk
from ergodic_exploration_tpu_torch.ops import target as target_ops

torch.set_num_threads(2)


def _bands(h, bh, n_bands):
    return [(i * bh, min(h, (i + 1) * bh)) for i in range(n_bands)] if n_bands else [(0, h)]


def _check_plan(h, w, K, r, fc, max_smem):
    bh, n_bands = mk.band_plan(h, w, K, r, fc, max_smem)
    bands = _bands(h, bh, n_bands)
    # the bands cover [0, h) once, in order, none empty
    assert bands[0][0] == 0 and bands[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert all(y1 > y0 for y0, y1 in bands)
    m = max(r, fc)
    if n_bands == 0:
        assert bh == h and mk.smem_bytes(h, w, K) <= max_smem
    else:
        assert mk.smem_bytes(h, w, K) > max_smem  # a map that fits keeps the single launch
        for y0, y1 in bands:  # every band with its halo fits one block
            rows = min(h, y1 + m) - max(0, y0 - m)
            assert mk.smem_bytes(rows, w, K, y1 - y0) <= max_smem
    return bh, n_bands


@pytest.mark.parametrize("h,w", [(100, 100), (150, 150), (200, 200), (300, 200)])
def test_band_plan_of_the_named_maps(h, w):
    bh, n_bands = _check_plan(h, w, 10, 3, 3, mk.MAX_SMEM)
    assert (n_bands == 0) == (h == 100)  # 150 x 150 is 237,000 bytes at K = 10, over the limit
    if n_bands:  # sized so that two blocks share an SM
        assert mk.smem_bytes(min(h, bh + 6), w, 10, bh) <= mk.PAIR_SMEM


@settings(max_examples=200, deadline=None)
@given(h=st.integers(1, 700), w=st.integers(1, 700), K=st.integers(1, 16), r=st.integers(0, 12),
       fc=st.integers(0, 12), max_smem=st.sampled_from([mk.MAX_SMEM, 48 * 1024, 100_000]))
def test_band_plan_covers_the_map_and_fits(h, w, K, r, fc, max_smem):
    if K > min(h, w):
        return
    try:
        _check_plan(h, w, K, r, fc, max_smem)
    except ValueError as e:
        # refused only when one row with its halo does not fit
        rows = min(h, 1 + 2 * max(r, fc))
        assert mk.smem_bytes(rows, w, K, 1) > max_smem and f"{max_smem}-byte limit" in str(e)


def test_a_200x200_map_is_planned_not_refused():
    """The map the JAX kernel's ``_pick_sc`` comment names: the wrapper plans
    row bands for it (and the launch then fails only for want of a card)."""
    assert mk.smem_bytes(200, 200, 10) > mk.MAX_SMEM
    bh, n_bands = mk.band_plan(200, 200, 10, 3, 3)
    assert n_bands >= 2 and bh * n_bands >= 200 > bh * (n_bands - 1)
    big = torch.zeros(1, 200, 200)
    ops = mk.MiOperands(torch.zeros(200, 10), torch.zeros(10, 200), torch.zeros(10, 10),
                        torch.ones(1))
    mk.K3.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):  # past the plan, at the device check
        mk.K3(big, ops, 3, 3)
    assert sum(mk.K3.launches.values()) == 0


def phik_from_grid_bandwise(data, ops, r, fc, bands, thr=0.65, eps=1e-6):
    """The row-band form in plain PyTorch: per band the stages on its rows
    with the halo, a partial contraction; then the ordered finish."""
    S, h, w = data.shape
    m = max(r, fc)
    parts = []
    for y0, y1 in bands:
        a0, a1 = max(0, y0 - m), min(h, y1 + m)
        loc = data[:, a0:a1]
        e = target_ops.entropy(torch.where(loc < 0.0, torch.full_like(loc, 0.5), loc), eps)
        free = loc < thr
        kf = ((loc >= 0.0) & free).to(torch.int32)
        tx, cx = mk._clamped_sum(e, r, -1), mk._clamped_sum(kf, fc, -1)  # x: the map's own edges
        rows = torch.arange(y0, y1)

        def ysum(x, rad):  # clamped at the MAP's edge, read from the band's local rows
            out = torch.zeros_like(x[:, y0 - a0:y1 - a0])
            for d in range(-rad, rad + 1):
                out += x[:, torch.clamp(rows + d, 0, h - 1) - a0]
            return out

        keep = free[:, y0 - a0:y1 - a0]
        if fc > 0:
            keep = keep & (ysum(cx, fc) > 0)
        t2 = ysum(tx, r)
        vals = torch.clamp(torch.where(keep, t2, torch.zeros_like(t2)), min=0.0)
        w1 = torch.matmul(vals, ops.cxA)  # (S, rows, K1)
        parts.append(torch.matmul(ops.cyA[:, y0:y1], w1).transpose(-1, -2))
    raw = torch.zeros_like(parts[0])
    for p in parts:  # band order
        raw = raw + p
    total = (raw[:, 0, 0] * ops.hk00)[:, None, None]
    return torch.where(total > 1e-12, raw / torch.clamp(total, min=1e-12), ops.fallback)


def _beliefs(S, h, w, seed):
    rng = np.random.default_rng(seed)
    data = np.full((S, h, w), -1.0, np.float32)
    data[:, :, : w // 2] = 0.0
    data[:, h // 4:h // 4 + 4, w // 10:w // 3] = 1.0
    for s in range(S):
        r0 = rng.integers(0, h - 6)
        data[s, r0:r0 + 6, w // 2:w // 2 + 8] = rng.uniform(0.0, 1.0, (6, 8)).astype(np.float32)
    return data


@pytest.mark.parametrize("r,fc,bh", [(3, 3, 40), (0, 3, 40), (3, 0, 67), (2, 5, 7), (4, 1, 200)])
def test_bandwise_evaluation_equals_the_plain_version(r, fc, bh):
    """Halo at the first and last band, fc > r and r > fc, a band shorter than
    its halo, one band that is the whole map."""
    h, w, K = 200, 120, 6
    data = torch.from_numpy(_beliefs(3, h, w, 21))
    data[2] = 1.0  # fully occupied: the fallback
    g0 = GridMap(data[0], torch.zeros(2), torch.tensor(0.05))
    ops = mk.mi_operands(g0, Domain.create(0.0, 0.0, w * 0.05, h * 0.05), K, (37, 41))
    ref = mk.phik_from_grid_plain(data, ops, r, fc)
    got = phik_from_grid_bandwise(data, ops, r, fc, _bands(h, bh, -(-h // bh)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0.0, atol=2e-6)
    np.testing.assert_array_equal(got[2].numpy(), ops.fallback.numpy())


def test_bandwise_evaluation_matches_the_jax_dense_path_at_200x200():
    S, h, w, K, ns, r = 2, 200, 200, 10, (100, 100), 3
    data = _beliefs(S, h, w, 22)
    jeng = JEngine(j_default_config("cart"))
    ref = np.asarray(jeng._phik_grid_batch_dense_fn(
        JGridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                 jnp.full((S,), 0.05, jnp.float32)), JDomain.create(0.0, 0.0, 10.0, 10.0), r))
    t = torch.from_numpy(data)
    g0 = GridMap(t[0], torch.zeros(2), torch.tensor(0.05))
    ops = mk.mi_operands(g0, Domain.create(0.0, 0.0, 10.0, 10.0), K, ns)
    bh, n_bands = mk.band_plan(h, w, K, r, 3)
    got = phik_from_grid_bandwise(t, ops, r, 3, _bands(h, bh, n_bands)).numpy()
    assert n_bands >= 2 and got.shape == (S, K, K) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
