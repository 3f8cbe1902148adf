"""K2's module: the port's phik_from_gmm (plain version of the kernel, on CPU
tensors) against the JAX package's Pallas kernel ``phik_from_gmm_pallas`` in
interpret mode, unmasked, masked and with degenerate scenarios (both
fallbacks); and Engine.phik_from_gmm's per-scenario-mask branch against the
JAX engine. Inputs come from a numpy seed and go to both packages.

Tolerance: atol 2e-5, the budget the JAX package holds its own kernel to
(tests/test_engine.py); both sides sum 400 float32 terms in another order.
"""

import re

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
from ergodic_exploration_tpu.ops.pallas_kernels import phik_from_gmm_pallas
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

torch.set_num_threads(2)
# a 20 x 20 lattice on 60 x 60 maps of 0.05 m: every lattice point is a cell
# centre, so no nearest-cell lookup of the free mask sits on a rounding tie
S, K, NS = 8, 6, (20, 20)
OPTS = dict(num_basis=K, buffer_capacity=64, grid_samples=NS)


def _operands(seed=5):
    """GMMs (two of them degenerate), distinct per-scenario masks (one all
    occupied), and the JAX package's lattice + dense table, as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32)
    means[1] = 400.0  # far outside the domain: phi underflows everywhere
    covs = np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    covs[:, 1, 0, 1] = covs[:, 1, 1, 0] = 0.05
    w = rng.uniform(0.5, 1.5, (S, 2)).astype(np.float32)
    mask = (rng.uniform(size=(S, NS[0] * NS[1])) > 0.3).astype(np.float32)
    mask[2] = 0.0  # fully occupied
    mask[3, :200] = 0.0
    dom = JDomain.create(0.0, 0.0, 3.0, 3.0)
    pts = dom.sample_lattice(NS)
    D = jbasis.dense_table(jbasis.tables(pts, K, dom), jbasis.hk_norm(K, dom.lengths))
    return means, covs, w, mask, np.asarray(pts), np.asarray(D)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k2_plain_matches_pallas_interpret(masked):
    means, covs, w, mask, pts, D = _operands()
    m = mask if masked else None
    ref = np.asarray(phik_from_gmm_pallas(
        jnp.asarray(means), jnp.asarray(covs), jnp.asarray(w), jnp.asarray(pts),
        jnp.asarray(D), interpret=True, free_mask=None if m is None else jnp.asarray(m)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    gk.K2.reset_launches()
    got = gk.phik_from_gmm(t(means), t(covs), t(w), t(pts), t(D),
                           None if m is None else t(m)).numpy()
    assert got.shape == (S, K * K) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # the degenerate rows took their fallbacks
    if masked:
        np.testing.assert_allclose(got[2], 0.0, atol=1e-12)  # empty mask: 0 / max(0, 1)
        np.testing.assert_allclose(got[1], (mask[1] @ D) / mask[1].sum(), atol=2e-5)
    else:
        np.testing.assert_allclose(got[1], D.sum(0) / D.shape[0], atol=2e-5)
    assert sum(gk.K2.launches.values()) == 0 and gk.K2.built is None


def _distinct_grids(seed=7):
    rng = np.random.default_rng(seed)
    data = np.zeros((S, 60, 60), np.float32)
    for s in range(S):
        r, c = rng.integers(5, 50, 2)
        data[s, r:r + 4, c:c + 8] = 1.0
    return data


@pytest.mark.parametrize("use_pallas", [True, False], ids=["k2", "plain_contraction"])
def test_engine_phik_per_scenario_mask_matches_jax(use_pallas):
    """shared_maps=False with distinct maps: the (S, N) mask multiplies phi
    before the normalizer. The JAX engine runs its Pallas kernel in interpret
    mode (use_pallas, S % 8 == 0) or its XLA contraction."""
    means, covs, w, _, _, _ = _operands()
    data = _distinct_grids()
    je = JEngine(j_default_config("cart").replace(use_pallas=use_pallas, **OPTS))
    jw = je.prepare_world(JGridMap(jnp.asarray(data), jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    ref = np.asarray(je.phik_from_gmm(jtarget.GaussianMixture.create(means, covs, w),
                                      JDomain.create(0.0, 0.0, 3.0, 3.0), jw))
    te = Engine(default_config("cart").replace(use_pallas=use_pallas, **OPTS), device="cpu")
    tw = te.prepare_world(GridMap(torch.from_numpy(data), torch.zeros(S, 2),
                                  torch.full((S,), 0.05)))
    np.testing.assert_array_equal(tw.free_mask.numpy(), np.asarray(jw.free_mask))
    got = te.phik_from_gmm(GaussianMixture.create(means, covs, w),
                           Domain.create(0.0, 0.0, 3.0, 3.0), tw)
    assert got.shape == (S, K, K)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_engine_phik_runs_for_ragged_batches():
    """On the port K2's route has no S % 8 rule: S = 3 and S = 8 rows agree."""
    means, covs, w, mask, _, _ = _operands()
    te = Engine(default_config("cart").replace(**OPTS), device="cpu")
    dom = Domain.create(0.0, 0.0, 3.0, 3.0)
    t = torch.from_numpy
    full = te.phik_from_gmm(GaussianMixture.create(means, covs, w), dom, t(mask))
    part = te.phik_from_gmm(GaussianMixture.create(means[:3], covs[:3], w[:3]), dom, t(mask[:3]))
    np.testing.assert_allclose(part.numpy(), full[:3].numpy(), atol=1e-6)


@pytest.mark.parametrize("S_,chunks,sms", [(1, 157, 132), (100, 157, 132), (4096, 157, 132),
                                           (33, 15, 132), (8, 1, 16)])
def test_lattice_split_covers_every_chunk(S_, chunks, sms):
    nsplit, per = gk.lattice_split(S_, chunks, sms)
    assert 1 <= nsplit <= chunks and (nsplit - 1) * per < chunks <= nsplit * per
    if S_ == 1:  # one scenario is spread over the whole card
        assert nsplit == chunks and per == 1


def test_k2_params_mirror_the_c_struct():
    assert [f[0] for f in gk._Params._fields_] == [
        "S", "J", "KK", "Npad", "n_real", "nsplit", "chunks_per_split", "masked"]
    # the struct in the source lists the same fields in the same order
    src = open(gk.__file__.replace("ops/gmm_kernel.py", "csrc/gmm_kernel.cu")).read()
    body = src[src.index("struct K2Params {"):src.index("// Mirror of ops/gmm_kernel.py::_Buffers")]
    body = re.sub(r"//.*", "", body)
    assert re.findall(r"\b([A-Za-z_]\w*)\s*[,;]", body) == [f[0] for f in gk._Params._fields_]
    assert [f[0] for f in gk._Buffers._fields_] == list(gk._BUFFERS)
    pts, D = gk.pad_lattice(torch.zeros(400, 2), torch.ones(400, 36))
    assert pts.shape == (448, 2) and D.shape == (448, 36) and (D[400:] == 0).all()
