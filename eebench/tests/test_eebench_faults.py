"""The check catches a broken timed path: a whole run on the CPU at a small
size (the look for a card skipped), with the program's entry point broken
underneath, must come out not correct; the sound program must come out
correct. The faults a cell can have here: a step that hands back its state
unchanged, half of the batch left out (its rows' answers never computed),
and an answer altered where it is produced. No cell exchanges data between
chips, so the fourth fault (the exchange left out) has no place to occur."""

import pytest
import torch

from eebench import harness, program

CELLS = ["cart_gmm_replan", "omni_mi_mapping", "omni_mi_replan", "cart_gmm_explore"]
SCALE = {"scenarios": 6, "samples": 1, "refreshes": 2, "ticks_per_call": 4, "check_rows": 4}
ENTRIES = ("replan_refresh", "replan_refresh_mi", "explore", "explore_mapping_fused")


def _half(t, fill):
    t = t.clone()
    t[..., t.shape[-1] // 2:] = fill
    return t


def _broken(sc_in, out, fault, entry):
    """``out`` of ``entry`` called on ``sc_in``, broken by ``fault``."""
    if entry.startswith("replan"):
        sc, u, diag = out
        S = u.shape[0]
        if fault == "state_unchanged":
            return sc._replace(state=sc_in.state), u, diag
        if fault == "half_batch":
            u = u.clone()
            u[S // 2:] = 0.0
            return sc, u, diag._replace(ergodic_metric=_half(diag.ergodic_metric, 0.0))
        return sc, u + 0.5, diag
    if entry == "explore":
        if fault == "state_unchanged":
            return out._replace(scenarios=sc_in)
        if fault == "half_batch":
            S = out.controls.shape[1]
            c, tr = out.controls.clone(), out.trajectory.clone()
            c[:, S // 2:] = 0.0
            tr[:, S // 2:] = sc_in.x[S // 2:]
            return out._replace(controls=c, trajectory=tr)
        return out._replace(controls=out.controls + 0.5)
    sc, belief, cov, traj, metric = out
    if fault == "state_unchanged":
        return sc_in, belief, cov, traj, metric
    if fault == "half_batch":
        S = traj.shape[2]
        traj = traj.clone()
        traj[:, :, S // 2:] = sc_in.x[S // 2:]
        return sc, belief, cov, traj, _half(metric, 0.0)
    return sc, belief, cov, traj, metric * 1.5


class _Broken:
    """The program's engine with its entry points broken by ``fault``."""

    def __init__(self, engine, fault):
        self._engine, self._fault = engine, fault

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name not in ENTRIES:
            return attr

        def call(sc, *args, **kw):
            return _broken(sc, attr(sc, *args, **kw), self._fault, name)

        return call


class _StaleTarget:
    """The program's engine with the mapping episode's MI target made at its
    first refresh and reused at every later one (a stale answer)."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name != "explore_mapping_fused":
            return attr

        def call(*args, **kw):
            eng, made = self._engine, []
            fresh = type(eng)._phik_grid_batch_dense_fn

            def frozen(*a, **k):
                if not made:
                    made.append(fresh(eng, *a, **k))
                return made[0]

            eng._phik_grid_batch_dense_fn = frozen
            try:
                return attr(*args, **kw)
            finally:
                del eng._phik_grid_batch_dense_fn

        return call


def _program(fault):
    port = program.port()
    if fault is None:
        return port
    return port._replace(make_engine=lambda d, dev: _Broken(port.make_engine(d, dev), fault))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_check_catches_the_fault(cell, fault):
    torch.manual_seed(0)
    r = harness.run_cell(cell, 20251018, 0.2, False, "cpu", _program(fault), scale=SCALE)
    assert r["attempted"] >= 1
    failed = {n: c for n, c in r["checks"].items() if c["value"] > c["limit"]}
    if fault is None:
        assert r["correct"] and not failed, r["checks"]
    else:
        assert not r["correct"] and failed, (fault, r["checks"])


def test_mapping_check_catches_a_stale_target():
    port = program.port()
    stale = port._replace(make_engine=lambda d, dev: _StaleTarget(port.make_engine(d, dev)))
    torch.manual_seed(0)
    r = harness.run_cell("omni_mi_mapping", 20251018, 0.2, False, "cpu", stale, scale=SCALE)
    failed = {n: c for n, c in r["checks"].items() if c["value"] > c["limit"]}
    assert not r["correct"] and failed, r["checks"]
