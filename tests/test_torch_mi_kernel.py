"""K3's module: ``mi_operands`` and the plain version of the kernel (on CPU
tensors) against the JAX package's Pallas kernel ``phik_from_grid_pallas`` in
interpret mode and against its dense XLA path, on the beliefs of
tests/test_mi_kernel.py (S = 8, 40 x 40 cells, K = 6, a 23 x 23 lattice that
avoids half-cell boundaries, the last scenario fully occupied), for
r in {0, 2, 3} x fc in {0, 3}.

Tolerance: rtol 2e-4, atol 2e-5, the budget the JAX package holds its own
kernel to against its dense path (tests/test_mi_kernel.py): the paths sum
1,600 cells (or 529 lattice points) of float32 in another order.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops import mi_kernel as jmk
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import mi_kernel as mk

torch.set_num_threads(2)
S, H, W, K, NS = 8, 40, 40, 6, (23, 23)
TOL = dict(rtol=2e-4, atol=2e-5)


def _beliefs():
    """tests/test_mi_kernel.py::_grids, as numpy."""
    rng = np.random.default_rng(7)
    data = np.full((S, H, W), -1.0, dtype=np.float32)
    data[:, :, : W // 2] = 0.0  # observed-free half
    data[:, 10:14, 5:15] = 1.0  # a wall in the known half
    for s in range(S):
        r0 = rng.integers(0, H - 6)
        data[s, r0:r0 + 6, W // 2:W // 2 + 8] = rng.uniform(0.0, 1.0, (6, 8)).astype(np.float32)
    data[S - 1] = 1.0  # fully occupied -> degenerate fallback
    return data


def _jgrids(data):
    return JGridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                    jnp.full((S,), 0.05, jnp.float32))


def _tgrids(data):
    return GridMap(torch.from_numpy(data), torch.zeros(S, 2), torch.full((S,), 0.05))


def _ops():
    g = _tgrids(_beliefs())
    g0 = GridMap(g.data[0], g.origin[0], g.resolution[0])
    return mk.mi_operands(g0, Domain.create(0.0, 0.0, 2.0, 2.0), K, NS)


def test_mi_operands_match_jax():
    jg = _jgrids(_beliefs())
    g0 = jax.tree.map(lambda a: a[0], jg)
    jd = JDomain.create(0.0, 0.0, 2.0, 2.0)
    _, jcxA, jcyA, cosx, cosy = jmk.mi_operands(g0, jd, K, NS, 2, 128, 128)
    ops = _ops()
    assert ops.cxA.shape == (W, K) and ops.cyA.shape == (K, H) and ops.hk00.shape == (1,)
    np.testing.assert_allclose(ops.cxA.numpy(), np.asarray(jcxA)[:W, :K], atol=1e-6)
    np.testing.assert_allclose(ops.cyA.numpy(), np.asarray(jcyA), atol=1e-6)
    # zero rows beyond the map in the TPU layout: nothing was cut off
    assert not np.asarray(jcxA)[W:].any() and not np.asarray(jcxA)[:, K:].any()
    from ergodic_exploration_tpu.ops import basis as jbasis

    hk = jbasis.hk_norm(K, jd.lengths)
    fb = (jnp.sum(cosx, 0)[:, None] * jnp.sum(cosy, 0)[None, :]) / (float(NS[0] * NS[1]) * hk)
    np.testing.assert_allclose(ops.fallback.numpy(), np.asarray(fb), atol=1e-6)
    np.testing.assert_allclose(ops.hk00.numpy(), np.asarray(hk)[0, 0], rtol=1e-6)


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX dense path for every (r, fc), computed once."""
    data = _beliefs()
    out = {}
    for fc in (0, 3):
        eng = JEngine(j_default_config("cart").replace(num_basis=K, grid_samples=NS,
                                                       mi_frontier_cells=fc))
        for r in (0, 2, 3):
            out[r, fc] = np.asarray(eng._phik_grid_batch_dense_fn(
                _jgrids(data), JDomain.create(0.0, 0.0, 2.0, 2.0), r))
    return out


@pytest.mark.parametrize("fc", [0, 3])
@pytest.mark.parametrize("r", [0, 2, 3])
def test_k3_plain_matches_pallas_interpret_and_dense(r, fc, jax_dense):
    data = _beliefs()
    jg = _jgrids(data)
    g0 = jax.tree.map(lambda a: a[0], jg)
    ref = np.asarray(jmk.phik_from_grid_pallas(
        jg.data, g0, JDomain.create(0.0, 0.0, 2.0, 2.0), K, NS, sensor_radius_cells=r,
        frontier_cells=fc, interpret=True))
    mk.K3.reset_launches()
    got = mk.phik_from_grid(torch.from_numpy(data), _ops(), r, fc).numpy()
    assert got.shape == (S, K, K) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_dense[r, fc], **TOL)
    # the fully occupied scenario took the uniform fallback, the others did not
    np.testing.assert_array_equal(got[S - 1], _ops().fallback.numpy())
    assert np.abs(got[0] - got[S - 1]).max() > 1e-3
    assert sum(mk.K3.launches.values()) == 0 and mk.K3.built is None  # CPU: plain only


@pytest.mark.parametrize("r,fc", [(0, 3), (3, 3), (2, 0)])
def test_three_formulations_of_the_port_agree(r, fc):
    """The plain K3 (cell space, clamped sums), the dense path (lattice
    space, count-matrix matmuls) and the separable path (cumulative-sum blur)
    of the port give one phi_k."""
    data = _beliefs()
    eng = Engine(default_config("cart").replace(num_basis=K, grid_samples=NS,
                                                mi_frontier_cells=fc), device="cpu")
    g = _tgrids(data)
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    plain = mk.phik_from_grid_plain(g.data, _ops(), r, fc).numpy()
    dense = eng.phik_from_grid(g, r, domain=dom).numpy()
    sep = eng.phik_from_grid(g, r).numpy()
    np.testing.assert_allclose(plain, dense, **TOL)
    np.testing.assert_allclose(plain, sep, **TOL)


@pytest.mark.parametrize("fc", [3, 200])
def test_k3_plain_matches_pallas_on_a_map_smaller_than_K(fc):
    """8 x 8 beliefs with K = 10, r = 1: a corridor narrower than K cells,
    which the JAX kernel takes (K <= 128); fc = 200 reaches past every edge."""
    rng = np.random.default_rng(3)
    data = np.full((2, 8, 8), -1.0, np.float32)
    data[:, :, :4] = 0.0
    data[:, 2, 1:3] = 1.0
    data[0, 5:8, 4:7] = rng.uniform(0.0, 1.0, (3, 3)).astype(np.float32)
    data[1] = rng.uniform(0.0, 1.0, (8, 8)).astype(np.float32)
    jg = JGridMap(jnp.asarray(data), jnp.zeros((2, 2), jnp.float32),
                  jnp.full((2,), 0.05, jnp.float32))
    ref = np.asarray(jmk.phik_from_grid_pallas(
        jg.data, jax.tree.map(lambda a: a[0], jg), JDomain.create(0.0, 0.0, 0.4, 0.4), 10,
        (10, 10), sensor_radius_cells=1, frontier_cells=fc, interpret=True))
    g = GridMap(torch.from_numpy(data), torch.zeros(2, 2), torch.full((2,), 0.05))
    ops = mk.mi_operands(GridMap(g.data[0], g.origin[0], g.resolution[0]),
                         Domain.create(0.0, 0.0, 0.4, 0.4), 10, (10, 10))
    got = mk.phik_from_grid(g.data, ops, 1, fc).numpy()
    assert got.shape == (2, 10, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - ops.fallback.numpy()).max() > 1e-3  # neither took the fallback


def test_k3_honours_the_occupied_threshold():
    """Cells at 0.55 are free at threshold 0.65 and obstacles at 0.5: they
    carry target mass and seed the frontier only in the first case."""
    data = np.full((1, H, W), -1.0, np.float32)
    data[:, :, :10] = 0.55
    hi = mk.phik_from_grid_plain(torch.from_numpy(data), _ops(), 2, 3, 0.65)
    lo = mk.phik_from_grid_plain(torch.from_numpy(data), _ops(), 2, 3, 0.5)
    np.testing.assert_array_equal(lo[0].numpy(), _ops().fallback.numpy())  # no frontier at all
    assert (hi[0] - lo[0]).abs().max() > 1e-3


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    ops = _ops()
    data = torch.from_numpy(_beliefs())
    with pytest.raises(ValueError, match="float32"):
        mk.K3(data.double(), ops, 2, 3)
    with pytest.raises(ValueError, match=r"\(S, h, w\)"):
        mk.K3(data[0], ops, 2, 3)
    with pytest.raises(ValueError, match="operand cxA"):
        mk.K3(data[:, :, :30].contiguous(), ops, 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        mk.K3(data.transpose(1, 2), ops, 2, 3)
    with pytest.raises(ValueError, match="1 <= K <= 128"):
        mk.K3(data, ops._replace(cxA=torch.zeros(W, 129), cyA=torch.zeros(129, H),
                                 fallback=torch.zeros(129, 129)), 2, 3)
    with pytest.raises(ValueError, match="r >= 0 and fc >= 0"):
        mk.K3(data, ops, -1, 3)
    with pytest.raises(ValueError, match="r >= 0 and fc >= 0"):
        mk.K3(data, ops, 2, -1)
    # what no band plan can hold is still refused, and the limit is named: one
    # row of a 6000-wide map with its halo of 3 rows a side is over a block's memory
    assert mk.smem_bytes(100, 100, 10, None, 3) == 54000
    assert mk.smem_bytes(7, 6000, K, 1, 2) > mk.MAX_SMEM
    wide = torch.zeros(1, 40, 6000)
    wide_ops = ops._replace(cxA=torch.zeros(6000, K), cyA=torch.zeros(K, 40))
    with pytest.raises(ValueError, match=f"halo.*{mk.MAX_SMEM}-byte limit"):
        mk.K3(wide, wide_ops, 2, 3)
    # well-formed CPU operands: the kernel object still never runs the plain version;
    # K > min(h, w) and fc > 127 pass every check up to the device's
    mk.K3.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.K3(data, ops, 2, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.K3(data, ops, 2, 200)
    small = torch.from_numpy(_beliefs()[:, :4, :5].copy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.K3(small, ops._replace(cxA=ops.cxA[:5].contiguous(), cyA=ops.cyA[:, :4].contiguous()),
              1, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mk.phik_from_grid(data.to("meta"), ops, 2, 3)
    assert sum(mk.K3.launches.values()) == 0


def test_k3_raises_when_its_library_cannot_be_built():
    """Without nvcc the library cannot be had: building raises, nothing
    carries on with the plain version."""
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present: the library can be built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mk.K3.build()
    assert mk.K3.built is None


def test_k3_params_mirror_the_c_struct():
    assert [f[0] for f in mk._Params._fields_] == ["S", "h", "w", "K", "r", "fc", "bh", "n_bands",
                                                    "thr", "eps"]
    assert [f[0] for f in mk._Buffers._fields_] == list(mk._BUFFERS)
    src = (mk.__file__.replace("ops/mi_kernel.py", "csrc/mi_kernel.cu"))
    text = open(src).read()
    assert "int S, h, w, K, r, fc;" in text and "float thr, eps;" in text
    assert "int bh, n_bands;" in text and "float* part;" in text
    assert text.index("int bh, n_bands;") < text.index("float thr, eps;")
    assert "const float *data, *cxA, *cyA, *fallback, *hk00;" in text
    assert f"K3_MAX_SMEM = {mk.MAX_SMEM}" in text
