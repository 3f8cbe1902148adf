"""The dense MI target's module (ops/mi_dense_kernel.py): its plain version,
through ``Engine._phik_grid_batch_dense_fn`` on CPU tensors, against the JAX
package's ``Engine._phik_grid_batch_dense_fn`` on the same numpy beliefs:
a non-square 24 x 32 map with a 20 x 16 lattice (it skips rows and columns
of cells) and K = 6, for r in {0, 3} x fc in {0, 3}; scenarios of mixed
beliefs, an all-unknown one (the uniform fallback where the frontier mask is
on), a fully known one and a fully occupied one (the fallback); K = 130, past
the 128 coefficients of the JAX package's MI kernel (which M's twin, the
dense path, does not have), on a 5 x 4 lattice. Also the
operands' cache: built once per geometry, built anew after an in-place change
of the maps' origin.

Tolerance: rtol 1e-5 / atol 1e-6. Both sides are the same float32 matmul
chain (count matrices, then the (S, N) @ (N, K^2) contraction); XLA and
PyTorch sum those products in their own orders on this CPU. The kernel is
held to this plain version in tests/test_torch_cuda_host.py and on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import mi_dense_kernel as md

torch.set_num_threads(2)
S, H, W, K, NS = 6, 24, 32, 6, (20, 16)
RES = 0.05
# 13 mm past the map's corner: no lattice point on a half-cell tie (where the
# nearest cell would rest on the last bit of a division)
DOM = (0.013, 0.013, W * RES, H * RES)
TOL = dict(rtol=1e-5, atol=1e-6)
UNKNOWN, KNOWN, OCCUPIED = S - 3, S - 2, S - 1


def _beliefs():
    """Scenarios 0-2 mixed (unknown, known free, a wall, continuous patches,
    scattered known cells), then all unknown, fully known, fully occupied."""
    rng = np.random.default_rng(11)
    data = np.full((S, H, W), -1.0, np.float32)
    data[:, :, : W // 3] = 0.0
    data[:, 6:9, 2:12] = 1.0
    u = rng.uniform(size=(S, H, W))
    data = np.where(u < 0.05, 0.0, np.where(u > 0.97, 1.0, data)).astype(np.float32)
    for s in range(UNKNOWN):
        r0, c0 = rng.integers(0, H - 6), rng.integers(W // 3, W - 8)
        data[s, r0:r0 + 6, c0:c0 + 8] = rng.uniform(0.0, 1.0, (6, 8))
    data[UNKNOWN] = -1.0
    data[KNOWN] = np.where(rng.uniform(size=(H, W)) < 0.2, 1.0,
                           rng.uniform(0.0, 0.5, (H, W))).astype(np.float32)
    data[OCCUPIED] = 1.0
    return data


def _tgrids(data):
    return GridMap(torch.from_numpy(data), torch.zeros(S, 2), torch.full((S,), RES))


@pytest.mark.parametrize("r,fc", [(0, 0), (0, 3), (3, 0), (3, 3)])
def test_plain_dense_target_matches_jax(r, fc):
    data = _beliefs()
    opts = dict(num_basis=K, grid_samples=NS, mi_frontier_cells=fc)
    jeng = JEngine(j_default_config("cart").replace(**opts))
    ref = np.asarray(jeng._phik_grid_batch_dense_fn(
        JGridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                 jnp.full((S,), RES, jnp.float32)), JDomain.create(*DOM), r))
    eng = Engine(default_config("cart").replace(**opts), device="cpu")
    md.M.reset_launches()
    got = eng._phik_grid_batch_dense_fn(_tgrids(data), Domain.create(*DOM), r)
    assert got.shape == (S, K, K) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    fallback = eng._dense_ops(_tgrids(data), Domain.create(*DOM)).fallback
    took = [bool(torch.equal(got[s], fallback)) for s in range(S)]
    # the fallback where nothing is left to explore, nowhere else
    assert took == [False] * UNKNOWN + [fc > 0, False, True]
    assert sum(md.M.launches.values()) == 0 and md.M.built is None  # CPU: plain only


def test_plain_dense_target_matches_jax_past_k128():
    """K = 130 on a 5 x 4 lattice of the 24 x 32 maps, r = fc = 1, at the
    file's tolerance: the (N, K^2) table and contraction of both sides past
    the JAX MI kernel's K <= 128, which the dense path never had."""
    data, k, ns = _beliefs(), 130, (5, 4)
    opts = dict(num_basis=k, grid_samples=ns, mi_frontier_cells=1)
    jeng = JEngine(j_default_config("cart").replace(**opts))
    ref = np.asarray(jeng._phik_grid_batch_dense_fn(
        JGridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                 jnp.full((S,), RES, jnp.float32)), JDomain.create(*DOM), 1))
    eng = Engine(default_config("cart").replace(**opts), device="cpu")
    got = eng._phik_grid_batch_dense_fn(_tgrids(data), Domain.create(*DOM), 1)
    assert got.shape == (S, k, k) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    fallback = eng._dense_ops(_tgrids(data), Domain.create(*DOM)).fallback
    assert torch.equal(got[OCCUPIED], fallback) and not torch.equal(got[0], fallback)


def test_dense_operands_are_built_once_per_geometry():
    """``_dense_ops`` keys on the maps' origin and resolution and the domain
    (tensors and versions) and the map shape: a second call, a refresh and
    ``phik_from_grid`` reuse the entry, as a second mapping loop on the same
    maps reuses its own; an in-place change of the origin builds it anew,
    and the target follows the new geometry."""
    data = _beliefs()
    eng = Engine(default_config("cart").replace(num_basis=K, grid_samples=NS), device="cpu")
    grids, dom = _tgrids(data), Domain.create(*DOM)
    ops = eng._dense_ops(grids, dom)
    assert eng._dense_ops(grids, dom) is ops
    assert ops.cx.dtype == ops.cy.dtype == torch.int32
    assert ops.cx.shape == (NS[0],) and ops.cy.shape == (NS[1],) and ops.D.shape == (
        NS[0] * NS[1], K * K)
    # the lattice skips cells: 20 of 32 columns, 16 of 24 rows
    assert len(set(ops.cx.tolist())) == NS[0] and len(set(ops.cy.tolist())) == NS[1]
    first = eng.phik_from_grid(grids, 3, domain=dom)
    assert len(eng._dense_operands) == 1 and eng._dense_ops(grids, dom) is ops
    # the mapping loops' operands: the extent of scenario 0's map, keyed on the maps alone
    extent = eng._dense_ops(grids, None)
    assert eng._dense_ops(grids, None) is extent and len(eng._dense_operands) == 2
    assert torch.equal(extent.D, eng._dense_ops(
        grids, Domain(grids.origin[0], grids.domain().lengths[0])).D)
    grids.origin.add_(torch.tensor([0.2, 0.1]))  # the maps moved, in place
    moved = eng._dense_ops(grids, dom)
    assert moved is not ops and len(eng._dense_operands) == 4
    assert not torch.equal(moved.cx, ops.cx) and not torch.equal(moved.cy, ops.cy)
    again = eng.phik_from_grid(grids, 3, domain=dom)
    fresh = Engine(eng.config, device="cpu").phik_from_grid(
        GridMap(grids.data, grids.origin.clone(), grids.resolution), 3, domain=dom)
    assert torch.equal(again, fresh) and not torch.equal(again, first)
