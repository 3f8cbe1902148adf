"""The port's quality tools against the JAX package's on the CPU:
``ergodic_exploration_tpu_torch.tools.quality`` against
``tools/tpu_quality.py`` (the building, the spawns, the quality loop at
``default_config("omni")``, the summary, the record's verdict, the command
line), ``tools.diag_plateau`` against ``tools/diag_plateau.py`` (the host
loop, the report, the command line), and the twins of
``tests/test_quality.py``'s orbit-guard and multi-room tests.

Tolerances of the quality loop are those of tests/test_torch_mapping.py:
beliefs cell for cell, coverage atol 1e-6; the first refresh's poses atol
5e-5 and metric rtol 1e-5 (the parity budget of tests/test_solve_kernel.py);
the second refresh's at ``LATE`` (poses 1e-4, metric rtol 1e-4), since its
ticks start from states that differ by rounding.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.controller import orbit_guard as j_orbit_guard
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.ops import sensor as jsensor
from ergodic_exploration_tpu.ops.buffer import RingBuffer as JRingBuffer
from ergodic_exploration_tpu.ops.distance import DistanceField as JDistanceField
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.controller import orbit_guard
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.tools import diag_plateau, quality

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from tools import tpu_quality  # noqa: E402  (the JAX tool, at the repo's root)

torch.set_num_threads(2)
LATE = dict(x=1e-4, metric=1e-4)
S_LOOP, R_LOOP, E_LOOP = 2, 2, 3  # the quality loop: spawns, refreshes, ticks a refresh


def _jax_spawns(S, seed=0):
    """tools/tpu_quality.py's spawn loop, replayed with the JAX DistanceField."""
    cfg = j_default_config("omni")
    truth = tpu_quality.build_truth(S)
    edt = np.asarray(JDistanceField.from_grid(jax.tree.map(lambda a: a[0], truth)).dist)
    need = cfg.boundary_radius + cfg.d_safe
    rng = np.random.default_rng(seed)
    xs = []
    while len(xs) < S:
        p_ = rng.uniform(0.3, 4.7, 2)
        ij = (int(p_[1] / 0.05), int(p_[0] / 0.05))
        if edt[ij] > need:
            xs.append([p_[0], p_[1], rng.uniform(-np.pi, np.pi)])
    return np.asarray(xs, np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX references: the spawns at S = 256, the quality loop
    (``explore_mapping_fused`` at pure omni defaults) and the host-chunked
    loop of tools/diag_plateau.py, both at S = 2 for 2 x 3 ticks."""
    x0 = _jax_spawns(256)
    eng = JEngine(j_default_config("omni"))
    truth = tpu_quality.build_truth(S_LOOP)
    sc, b, cov, traj, em = eng.explore_mapping_fused(
        eng.init_scenarios(x0[:S_LOOP]), truth, n_refreshes=R_LOOP, refresh_every=E_LOOP,
        sensor_range=1.5)
    fused = dict(belief=np.asarray(b.data), cov=np.asarray(cov), traj=np.asarray(traj),
                 em=np.asarray(em))
    win = jsensor.raycast_window_cells(1.5, 0.05)
    reveal = jax.jit(jax.vmap(lambda b, t, x: jsensor.reveal_raycast(
        b, t, x, 1.5, win, occupied_threshold=eng.config.occupied_threshold)))
    sc = eng.init_scenarios(x0[:S_LOOP])
    belief = truth._replace(data=jnp.full_like(truth.data, -1.0))
    chunks = []
    for _ in range(R_LOOP):
        belief = reveal(belief, truth, sc.x)
        out = eng.explore(sc, eng.phik_from_grid(belief), eng.prepare_world(belief), E_LOOP)
        sc = out.scenarios
        chunks.append((np.asarray(belief.data), np.asarray(out.trajectory),
                       np.asarray(out.diag.ergodic_metric), np.asarray(out.diag.collision_code)))
    return dict(x0=x0, fused=fused, chunks=chunks)


# ---------------------------------------------------------------- the building and the spawns


def test_build_truth_matches_the_jax_tool():
    ref = tpu_quality.build_truth(3)
    got = quality.build_truth(3, device="cpu")
    assert got.data.shape == (3, 100, 100)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_array_equal(got.resolution.numpy(), np.asarray(ref.resolution))


def test_spawn_poses_match_the_jax_tool(jax_runs):
    cfg = default_config("omni")
    got = quality.spawn_poses(cfg, quality.build_truth(256, device="cpu"), 256, seed=0)
    assert got.dtype == np.float32 and got.shape == (256, 3)
    np.testing.assert_array_equal(got, jax_runs["x0"])  # element for element


# ---------------------------------------------------------------- the quality loop


def test_quality_loop_matches_jax(jax_runs):
    sk.K1.reset_launches()
    r = quality.run(S_LOOP, R_LOOP, E_LOOP, 1.5, seed=0, device="cpu")
    assert sum(sk.K1.launches.values()) == 0  # CPU tensors: plain versions, no launch
    ref = jax_runs["fused"]
    np.testing.assert_array_equal(r.x0, jax_runs["x0"][:S_LOOP])
    assert r.trajectory.shape == (R_LOOP, E_LOOP, S_LOOP, 3)
    assert r.metric.shape == (R_LOOP, E_LOOP, S_LOOP) and r.coverage.shape == (R_LOOP,)
    np.testing.assert_array_equal(r.belief.data.numpy(), ref["belief"])
    np.testing.assert_allclose(r.coverage.numpy(), ref["cov"], atol=1e-6)
    traj, em = r.trajectory.numpy(), r.metric.numpy()
    np.testing.assert_allclose(traj[0], ref["traj"][0], atol=5e-5)
    np.testing.assert_allclose(em[0], ref["em"][0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(traj[1], ref["traj"][1], atol=LATE["x"])
    np.testing.assert_allclose(em[1], ref["em"][1], rtol=LATE["metric"], atol=1e-7)
    assert r.wall_s > 0.0


def test_mapping_chunks_match_the_jax_host_loop(jax_runs):
    eng = Engine(default_config("omni"), device="cpu")
    truth = quality.build_truth(S_LOOP, device="cpu")
    sc = eng.init_scenarios(jax_runs["x0"][:S_LOOP])
    got = list(quality.mapping_chunks(eng, sc, truth, R_LOOP, E_LOOP, 1.5))
    assert len(got) == R_LOOP
    for c, ((belief, out), (b_ref, t_ref, m_ref, code_ref)) in enumerate(
            zip(got, jax_runs["chunks"])):
        tol = dict(x=5e-5, metric=1e-5) if c == 0 else LATE
        np.testing.assert_array_equal(belief.data.numpy(), b_ref)
        np.testing.assert_allclose(out.trajectory.numpy(), t_ref, atol=tol["x"])
        np.testing.assert_allclose(out.diag.ergodic_metric.numpy(), m_ref, rtol=tol["metric"],
                                   atol=1e-7)
        np.testing.assert_array_equal(out.diag.collision_code.numpy(), code_ref)


# ---------------------------------------------------------------- the summary and the verdict


def _jax_tool_summary(cov, bdata, em, S, n_refreshes, refresh_every, sensor_range):
    """tools/tpu_quality.py's summary lines, on numpy arrays."""
    cov_curve = cov.reshape(n_refreshes, -1).mean(axis=1)
    cov_s = (bdata != -1.0).reshape(S, -1).mean(axis=1)
    em_mean = em.mean(axis=2)
    em_curve = em_mean.reshape(-1)
    ticks = np.arange(1, n_refreshes + 1) * refresh_every
    return {
        "S": S,
        "n_refreshes": n_refreshes,
        "refresh_every": refresh_every,
        "sensor_range_m": sensor_range,
        "final_coverage": float(cov_curve[-1]),
        "final_coverage_per_scenario": {
            "p10": float(np.percentile(cov_s, 10)),
            "median": float(np.median(cov_s)),
            "p90": float(np.percentile(cov_s, 90)),
            "best": float(cov_s.max()),
        },
        "coverage_at": {str(int(t)): float(c) for t, c in
                        zip(ticks[:: max(1, n_refreshes // 8)],
                            cov_curve[:: max(1, n_refreshes // 8)])},
        "ergodic_metric_first_tick": float(em_curve[0]),
        "ergodic_metric_last_tick": float(em_curve[-1]),
        "ergodic_metric_last_refresh_mean": float(em_mean[-1].mean()),
        "coverage_curve": [round(float(c), 4) for c in cov_curve],
        "em_curve_per_refresh": [round(float(m), 6) for m in em_mean.mean(axis=1)],
    }


@pytest.mark.parametrize("R", [3, 20])
def test_summarize_matches_the_jax_tool(R):
    rng = np.random.default_rng(R)
    S, E = 7, 4
    cov = np.sort(rng.uniform(0.1, 0.9, R)).astype(np.float32)
    bdata = np.where(rng.uniform(size=(S, 10, 10)) < 0.4, -1.0,
                     rng.uniform(size=(S, 10, 10))).astype(np.float32)
    em = rng.uniform(0.01, 0.05, (R, E, S)).astype(np.float32)
    got = quality.summarize(cov, bdata, em, 1.5, wall_s=12.345)
    ref = _jax_tool_summary(cov, bdata, em, S, R, E, 1.5)
    assert got.pop("wall_s") == 12.3
    assert got == ref


RECORD = json.loads((ROOT / "docs" / "quality_config4.json").read_text())


def _shifted(dcov=0.0, dp10=0.0, dmedian=0.0):
    s = json.loads(json.dumps(RECORD))
    s["coverage_at"] = {k: v + dcov for k, v in s["coverage_at"].items()}
    s["final_coverage_per_scenario"]["p10"] += dp10
    s["final_coverage_per_scenario"]["median"] += dmedian
    return s


@pytest.mark.parametrize("summary,ok,n_failures", [
    (_shifted(), True, 0),
    (_shifted(dcov=0.05), False, 9),  # every coverage point, refresh 1's included
    (_shifted(dcov=-0.05), False, 9),
    (_shifted(dcov=0.02), False, 1),  # inside 0.03, outside refresh 1's 1e-3
    (_shifted(dp10=-0.06, dmedian=-0.03), False, 2),
    (_shifted(dp10=+0.1, dmedian=+0.1), True, 0),  # better than the record is no fault
], ids=["same", "up 0.05", "down 0.05", "up 0.02", "quantiles down", "quantiles up"])
def test_compare_to_record(summary, ok, n_failures):
    v = quality.compare_to_record(summary, RECORD)
    assert v["ok"] is ok and len(v["failures"]) == n_failures
    assert [row[0] for row in v["coverage_at"]] == [int(k) for k in RECORD["coverage_at"]]
    assert v["p10"][1] == RECORD["final_coverage_per_scenario"]["p10"]


def test_compare_to_record_refuses_another_configuration():
    with pytest.raises(ValueError, match="configuration"):
        quality.compare_to_record(dict(RECORD, S=128), RECORD)


# ---------------------------------------------------------------- the command line


def _docs_state():
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in (ROOT / "docs").iterdir()
            if p.is_file()}


def test_quality_cli_writes_its_json_and_leaves_docs_alone(tmp_path, capsys):
    before = _docs_state()
    out = tmp_path / "q.json"
    assert quality.main(["--S", "2", "--refreshes", "2", "--every", "2", "--cpu",
                         "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert (got["S"], got["n_refreshes"], got["refresh_every"]) == (2, 2, 2)
    assert got["device"] == "cpu" and "vs_record" not in got  # not the record's configuration
    assert len(got["coverage_curve"]) == 2 and 0.0 < got["final_coverage"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["S"] == 2
    with pytest.raises(SystemExit):
        quality.main(["--cpu", "--out", str(ROOT / "docs" / "quality_config4.json")])
    assert _docs_state() == before


def test_diag_plateau_command_line_parses_as_the_jax_tool():
    args, kw = diag_plateau.parse_argv(["8", "300", "_x", "orbit_window=0", "d_safe=0.3",
                                        "use_fused_solve=True", "history=ring", "--cpu"])
    assert args == (8, 300)
    assert kw == dict(device="cpu", tag="_x", orbit_window=0, d_safe=0.3, use_fused_solve=True,
                      history="ring")
    assert diag_plateau.parse_argv([]) == ((16, 1500), dict(tag=""))


def _jax_tool_diagnosis(traj, dwa, code, div, em, bdata, dt):
    """tools/diag_plateau.py's report lines, on numpy arrays."""
    S = traj.shape[1]
    cov_s = (bdata != -1.0).reshape(S, -1).mean(axis=1)

    def room_of(p):
        x, y = p[..., 0], p[..., 1]
        lower = y < 2.25
        mid = (y >= 2.25) & (y < 3.5)
        return np.where(lower, 0, np.where(mid, 1, 2))

    rooms = room_of(traj)
    room0 = rooms[0]
    crossed = (rooms != room0[None, :]).any(axis=0)
    d = np.linalg.norm(np.diff(traj[..., :2], axis=0), axis=-1)
    speed = d / dt
    doors = np.array([[(64 + 90) / 2 * 0.05, 46.5 * 0.05],
                      [16 * 0.05, 71.0 * 0.05]])
    dd = np.linalg.norm(traj[:, :, None, :2] - doors[None, None], axis=-1)
    min_door = dd.min(axis=2)
    return {
        "S": S, "n_ticks": traj.shape[0],
        "final_coverage_mean": float(cov_s.mean()),
        "cov_per_scenario": [round(float(v), 3) for v in cov_s],
        "crossed_rooms_frac": float(crossed.mean()),
        "room_time_frac": [float((rooms == r).mean()) for r in (0, 1, 2)],
        "mean_speed": float(speed.mean()),
        "p90_speed": float(np.percentile(speed, 90)),
        "dwa_active_rate": float(dwa.mean()),
        "code_rate": {str(k): float((code == k).mean()) for k in (0, 1, 2)},
        "diverged_rate": float(div.mean()),
        "em_first": float(em[0].mean()), "em_last": float(em[-1].mean()),
        "min_door_dist_ever": [round(float(v), 3) for v in min_door.min(axis=0)],
    }


def test_diagnose_matches_the_jax_tool():
    rng = np.random.default_rng(5)
    T, S = 50, 6
    traj = np.concatenate([rng.uniform(0.0, 5.0, (T, S, 2)), rng.uniform(-3, 3, (T, S, 1))],
                          axis=-1).astype(np.float32)
    dwa = rng.uniform(size=(T, S)) < 0.2
    code = rng.integers(0, 3, (T, S)).astype(np.int32)
    div = rng.uniform(size=(T, S)) < 0.05
    em = rng.uniform(0.01, 0.05, (T, S)).astype(np.float32)
    bdata = np.where(rng.uniform(size=(S, 12, 12)) < 0.5, -1.0, 0.0).astype(np.float32)
    cfg = default_config("omni")
    got = diag_plateau.diagnose(traj, dwa, code, div, em, bdata, cfg)
    assert got == _jax_tool_diagnosis(traj, dwa, code, div, em, bdata, cfg.dt)


def test_diag_plateau_main_writes_its_npz(tmp_path, monkeypatch):
    monkeypatch.setattr(diag_plateau, "ROOT", tmp_path)
    report = diag_plateau.main(2, 4, refresh_every=2, tag="_t", device="cpu")
    z = np.load(tmp_path / "build" / "diag_plateau_t.npz")
    assert z["traj"].shape == (4, 2, 3) and z["belief"].shape == (2, 100, 100)
    np.testing.assert_array_equal(z["x0"], quality.spawn_poses(
        default_config("omni"), quality.build_truth(2, device="cpu"), 2))
    assert report["n_ticks"] == 4 and report["device"] == "cpu"
    assert report["overrides"] == {"ergodic_weight": "200.0"}
    assert report["cov_per_scenario"] == [round(float(v), 3) for v in z["cov_s"]]


# ---------------------------------------------------------------- tests/test_quality.py's twins


def _buffers(path_xy, capacity=1024):
    """The same ring buffer (one scenario) for the JAX package and the port."""
    n = path_xy.shape[0]
    states = np.zeros((2, capacity), np.float32)
    states[:, :n] = path_xy.T
    jbuf = JRingBuffer(states=jnp.asarray(states), cursor=jnp.asarray(n % capacity, jnp.int32),
                       count=jnp.asarray(n, jnp.int32))
    tbuf = RingBuffer(states=torch.from_numpy(states)[None],
                      cursor=torch.tensor([n % capacity], dtype=torch.int32),
                      count=torch.tensor([n], dtype=torch.int32))
    return jbuf, tbuf


def _guard(opts, path_xy, p_now):
    jbuf, tbuf = _buffers(path_xy.astype(np.float32))
    jcfg = j_default_config("omni").replace(**opts)
    tcfg = default_config("omni").replace(**opts)
    ref = bool(j_orbit_guard(jcfg, jbuf, jnp.asarray(p_now, jnp.float32)))
    got = orbit_guard(tcfg, tbuf, torch.tensor(np.asarray(p_now, np.float32))[None])
    assert got.shape == (1,) and bool(got[0]) == ref
    return ref


def test_orbit_guard_ignores_healthy_sweep():
    line = np.stack([np.linspace(0, 2, 200), np.full(200, 1.0)], 1)
    assert not _guard({}, line, [2.0, 1.0])


def test_orbit_guard_waits_for_window_and_can_disable():
    ang = np.linspace(0.0, 6 * np.pi, 40)  # only 40 ticks of history
    circle = np.stack([1 + 0.05 * np.cos(ang), 1 + 0.05 * np.sin(ang)], 1)
    assert not _guard({}, circle, circle[-1])
    big = np.tile(circle, (6, 1))  # 240 >= window
    assert _guard({}, big, circle[-1])
    assert not _guard(dict(orbit_window=0), big, circle[-1])


@pytest.mark.slow
def test_default_config_explores_multiroom_map():
    """The default omni configuration explores on the port: on the quality
    building, S = 4 robots for 400 ticks at defaults move at > 0.04 m/s on
    average, reveal > 25 % of it, and still gain > 0.02 in the second half."""
    speed, coverage, rise = quality.multiroom_floors(Engine(default_config("omni"), device="cpu"))
    assert speed > quality.FLOOR_SPEED, f"stationary fleet: mean speed {speed:.3f}"
    assert coverage > quality.FLOOR_COVERAGE, f"no exploration: coverage {coverage:.3f}"
    assert rise > quality.FLOOR_RISE, f"coverage plateaued: second-half rise {rise:.3f}"
