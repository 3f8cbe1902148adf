"""The headline entry point's twin (``ergodic_exploration_tpu_torch/bench.py``)
against the root ``bench.py`` on the CPU.

The root ``bench.py`` is loaded by file path (its top level imports only
json, time and numpy), so the port imports nothing of it. Its cases at S = 4
are held element for element against the twin's; one tick of each on the
bench's full 100 x 100 lattice (K1's and K3's plain versions on the CPU) is
held against the JAX engine's vmapped path (``use_fused_solve=False,
use_pallas=False``) and its dense MI path under the budgets of
tests/test_solve_kernel.py: controls atol 5e-5, metric rtol 1e-5 / atol
1e-7, codes and DWA flags exact; phi_k rtol 2e-4 / atol 2e-5
(tests/test_mi_kernel.py).

PyTorch runs on one thread here: on some CPU hosts its worker threads were
seen to return wrong exp / log / sin / sqrt values (errors near 2e-4) for
the first multi-threaded call after a multi-threaded reduction, which the
EDT of a batch of maps makes.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ergodic_exploration_tpu.grid as jgrid
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu_torch import bench
from ergodic_exploration_tpu_torch.utils import interop

ROOT = Path(__file__).resolve().parents[1]
S = 4
MI_RADIUS = 3
KEYS = {"metric", "value", "unit", "mi_solves_per_s_per_chip", "mi_vs_gmm_tick",
        "mi_frontier_cells", "p50_replan_latency_ms", "p99_replan_latency_ms",
        "latency_spread_ms", "latency_reps", "latency_chain", "latency_budget_ms", "batch",
        "device", "card", "device_count"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cases():
    """Both packages' bench cases at S = 4; the maps the root bench builds
    are recorded as it passes them to ``GridMap``."""
    root = _root_bench()
    maps = []
    make = jgrid.GridMap

    def recording(*args, **kw):
        g = make(*args, **kw)
        maps.append(np.asarray(g.data))
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrid, "GridMap", recording)
        jgmm_case = root.build_case(S)
        jmi_case = root.build_case_mi(S)
    return {"gmm": (jgmm_case, bench.build_case(S, device="cpu"), maps[0]),
            "mi": (jmi_case, bench.build_case_mi(S, device="cpu"), maps[-1])}


@pytest.mark.parametrize("case", ["gmm", "mi"])
def test_case_matches_bench_py(cases, case):
    j, t, jmap = cases[case]
    jsc, tsc = j[1], t[1]
    np.testing.assert_array_equal(tsc.x.numpy(), np.asarray(jsc.x))
    if case == "gmm":
        (_, _, jgmm, _, jworld), (_, _, tgmm, _, tworld) = j, t
        for a, b in zip(tgmm, jgmm):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        tmap = bench.case_arrays(S).data
    else:
        (_, _, jgrids, jworld, _), (_, _, tgrids, tworld, _) = j, t
        np.testing.assert_array_equal(tgrids.data.numpy(), np.asarray(jgrids.data))
        tmap = tgrids.data[0].numpy()
    np.testing.assert_array_equal(np.broadcast_to(tmap, jmap.shape), jmap)
    np.testing.assert_allclose(tworld.dist.dist.numpy(), np.asarray(jworld.dist.dist),
                               rtol=0.0, atol=1e-6)
    np.testing.assert_array_equal(tworld.free_mask.numpy(), np.asarray(jworld.free_mask))


def _assert_tick_close(got, ref):
    (sc, u, dg), (sc_r, u_r, dg_r) = got, ref
    np.testing.assert_allclose(u, u_r, rtol=0.0, atol=5e-5)
    np.testing.assert_allclose(sc.state.U, sc_r.state.U, rtol=0.0, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    for f in ("collision_code", "dwa_active", "dwa_feasible", "diverged", "orbit_reset"):
        np.testing.assert_array_equal(getattr(dg, f), getattr(dg_r, f))


@pytest.mark.parametrize("case", ["gmm", "mi"])
def test_one_tick_matches_jax_engine(cases, case):
    """One tick of the twin's timed function against the JAX engine's
    vmapped path on the root bench's case; for the MI tick also phi_k of K3's
    plain version against the JAX dense path."""
    j, t, _ = cases[case]
    jeng = JEngine(j[0].config.replace(use_fused_solve=False, use_pallas=False))
    teng = t[0]
    if case == "gmm":
        (_, jsc, jgmm, jdom, jworld), (_, tsc, tgmm, tdom, tworld) = j, t
        ref = jax.jit(jeng._refresh_and_replan_fn)(jsc, jgmm, jdom, jworld)
        got = teng._refresh_and_replan_fn(tsc, tgmm, tdom, tworld)
    else:
        (_, jsc, jgrids, jworld, jdom), (_, tsc, tgrids, tworld, tdom) = j, t
        ref = jax.jit(lambda s, g, w: jeng._refresh_mi_and_replan_fn(
            s, g, w, MI_RADIUS, jdom, False))(jsc, jgrids, jworld)
        got = teng._refresh_mi_and_replan_fn(tsc, tgrids, tworld, MI_RADIUS, tdom,
                                             use_mi_kernel=True)
        np.testing.assert_allclose(
            teng._phik_grid_kernel(tgrids, tdom, MI_RADIUS).numpy(),
            np.asarray(jeng._phik_grid_batch_dense_fn(jgrids, jdom, MI_RADIUS)),
            rtol=2e-4, atol=2e-5)
    _assert_tick_close(interop.to_numpy(got), jax.tree.map(np.asarray, ref))


def test_run_returns_the_headline_keys():
    """``_run`` at toy sizes on the CPU: the JAX line's keys without
    ``vs_baseline``, the card's name and the device count beside them, and
    each timed function made once through ``watch``."""
    seen = []

    def watch(name, fn, **kw):
        reached = {}
        out = fn(reached=reached, **kw)
        seen.append((name, sorted(reached)))
        return out

    line = bench._run(device="cpu", S=2, iters=1, reps=2, group=1, chain=2, watch=watch)
    assert set(line) == KEYS and "vs_baseline" not in line
    assert [n for n, _ in seen] == ["throughput", "mi", "latency"]
    assert all("sc" in keys and "engine" in keys for _, keys in seen)
    assert line["device"] == "cpu" and line["card"] is None and line["batch"] == 2
    assert line["mi_frontier_cells"] == 3 and line["latency_chain"] == 2
    nums = [line[k] for k in ("value", "mi_solves_per_s_per_chip", "p50_replan_latency_ms",
                              "p99_replan_latency_ms")] + line["latency_spread_ms"]
    assert all(np.isfinite(v) and v > 0 for v in nums)


def test_entry_point_refuses_without_a_card():
    """``python -m ergodic_exploration_tpu_torch.bench`` with no CUDA device
    visible exits non-zero and prints no metric."""
    r = subprocess.run([sys.executable, "-m", "ergodic_exploration_tpu_torch.bench"], cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"value"' not in r.stdout + r.stderr
