"""Exploration episodes with online mapping, back to back: each request is
one ``Engine.explore_mapping_fused`` call, S robots spawned afresh from the
seed in the hidden building with unknown beliefs, ``refreshes`` map
refreshes of ``refresh_every`` ticks (each: the ray-cast reveal R, the dense
MI target M, the world rebuild E, then the ticks), ending with the
coverage, trajectory and ergodic metric on the host.

Traffic parameters: ``refreshes``; ``sensor_radius_cells`` (M's radius);
``samples``, the episodes after the first that the check compares;
``check_rows``, the scenarios whose beliefs it follows. The
sensor's range and the refresh period are the configuration's.

The check, for the first episode and the sampled ones: the plain reference
runs the first refresh itself from the spawns (its reveal, M, E) and its
first tick; compared are that tick's pose and ergodic metric. The later
refreshes are followed through what the episode hands back: for a seeded
sample of ``check_rows`` scenarios the reference reveals the hidden map
from the trajectory's pose at each refresh, and their final beliefs must
equal the program's; the last coverage must be the known share of the
program's final belief; the ring of the final state must hold the pose each
tick started from, and its history count the ticks run; all exactly. At
two refreshes drawn from the seed (one in each half of the episode) the
reference works out the MI target and the world again from its own beliefs
of those scenarios and runs the refresh's first tick from the state the
program reached there; compared, as for the first tick, are that tick's
pose and metric. That state comes from the timed entry point itself: after
the window the program reruns the episode's prefix up to that refresh at
the cell's size, and its trajectory must equal the episode's, exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from eebench import gen, program
from eebench.drivers import (Request, Samples, abs_gap, cells_off, k1_facts, later_points, limits,
                             p99, rel_gap, ring_off, take_rows)

record = torch.profiler.record_function
SUMMED = ("m_nonzero", "reveal_occupied", "reveal_blocked_bins")  # over scenarios


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.facts = {}
        self.later = {}  # the prefixes' states, made at release
        self.refreshes = int(ctx.param("refreshes"))
        self.every = int(ctx.config["fleet"]["refresh_every"])
        self.ticks_per_request = self.refreshes * self.every
        self.refreshes_per_request = self.refreshes

    def _spawns(self, episode: int):
        f = self.ctx.config["fleet"]
        return gen.spawn(gen.rng(self.ctx.seed, 10, episode + 1), self.ctx.scenarios, self.clear,
                         f["resolution"], self.need, 0.3, f["domain"][2] - 0.3)

    def _truth(self, prog, device):
        S, res = self.ctx.scenarios, self.ctx.config["fleet"]["resolution"]
        data = torch.as_tensor(self.truth, device=device).expand(S, *self.truth.shape)
        return prog.GridMap(data.contiguous(), torch.zeros((S, 2), device=device),
                            torch.full((S,), res, device=device))

    def _episode(self, sc, refreshes=None):
        f = self.ctx.config["fleet"]
        return self.engine.explore_mapping_fused(
            sc, self.truth_grid, n_refreshes=refreshes or self.refreshes,
            refresh_every=self.every,
            sensor_range=f["sensor_range"], sensor_radius_cells=self.ctx.param(
                "sensor_radius_cells"))

    def setup(self):
        ctx = self.ctx
        self.cfg = ctx.engine_config
        f = ctx.config["fleet"]
        self.truth = gen.building()
        self.clear = gen.clearance(self.truth, f["resolution"])
        self.need = self.cfg["boundary_radius"] + self.cfg["d_safe"]
        self.engine = ctx.program.make_engine(self.cfg, ctx.device)
        self.truth_grid = self._truth(ctx.program, self.engine.device)
        sc = self.engine.init_scenarios(self._spawns(-1))
        self._episode(sc)[2].cpu()  # the refresh's graph is captured and replayed
        self.samples = Samples(ctx.seed, ctx.param("samples"))
        self.i = 0

    def request(self) -> Request:
        t0 = time.perf_counter()
        with record("eebench.spawn"):
            x0 = self._spawns(self.i)
            sc = self.engine.init_scenarios(x0)
        with record("eebench.explore_mapping"):
            out = self._episode(sc)
        t1 = time.perf_counter()
        with record("eebench.readback"):
            cov, traj, metric = out[2].cpu(), out[3].cpu(), out[4].cpu()
        ok = bool(np.isfinite(cov.numpy()).all() and np.isfinite(traj.numpy()).all()
                  and np.isfinite(metric.numpy()).all())
        self.samples.offer(self.i, lambda: (x0, out))
        self.i += 1
        return Request(self.ctx.scenarios * self.ticks_per_request, ok, None, t1 - t0)

    def release(self):
        """After the window: each compared episode's prefix up to two seeded
        refreshes, rerun through the timed entry point, for the state the
        program reached there; then the program's state is freed."""
        self.later = {}
        for i, (x0, out) in self.samples.all():
            for k in later_points(gen.rng(self.ctx.seed, 97, i), 2, self.refreshes):
                sc_k, _, _, traj_k, _ = self._episode(self.engine.init_scenarios(x0), k)
                self.later.setdefault(i, {})[k] = (sc_k, cells_off(traj_k, out[3][:k]))
        self.engine = None

    def check(self):
        from eebench.reference.ops import sensor
        from eebench.reference.ops.mi_dense_kernel import dense_operands, phik_dense_plain
        from eebench.work import m as m_work
        from eebench.work import reveal as reveal_work

        ctx, f = self.ctx, self.ctx.config["fleet"]
        ref = program.reference().make_engine(self.cfg, ctx.device)
        truth = self._truth(program.reference(), ref.device)
        win = sensor.raycast_window_cells(f["sensor_range"], f["resolution"])
        r = ctx.param("sensor_radius_cells")
        thr = self.cfg["occupied_threshold"]
        ops = dense_operands(*ref._geometry(truth, None), ref.config.num_basis,
                             ref.config.grid_samples)
        studied = sorted({0, self.refreshes // 2, self.refreshes - 1})
        gaps = {"x": [], "metric": []}
        exact = 0
        ticks, counts = [], []
        counts_done = False  # the work counts are read on the first episode's refreshes
        for i, (x0, (sc_out, belief, cov, traj, metric)) in self.samples.all():
            # the first refresh and its first tick, all the reference's own
            sc0 = ref.init_scenarios(x0)
            unknown = truth._replace(data=torch.full_like(truth.data, -1.0))
            b = sensor.reveal_raycast_plain(unknown, truth, sc0.x, f["sensor_range"], win,
                                            occupied_threshold=thr, chunk=1024)
            with ref._precision():
                phik = phik_dense_plain(b.data, ops, r, ref.config.mi_frontier_cells, thr)
                world = ref._world(b, b.domain())
            sc1, u1, d1 = ref.tick(sc0, phik, world)
            ticks.append((sc0.x, sc0.vb, u1, d1))
            gaps["x"].append(abs_gap(traj[0, 0, :, :2], sc1.x[:, :2]))
            gaps["metric"].append(rel_gap(metric[0, 0], d1.ergodic_metric, 1e-6))
            # the later refreshes, from the poses the program reached, on a seeded
            # sample of the scenarios (the plain reveal of all of them would
            # outlast the window)
            rows = torch.as_tensor(np.sort(gen.rng(ctx.seed, 98).choice(
                ctx.scenarios, min(ctx.param("check_rows"), ctx.scenarios), replace=False)),
                device=ref.device)
            t_rows = truth._replace(data=truth.data[rows], origin=truth.origin[rows],
                                    resolution=truth.resolution[rows])
            b = t_rows._replace(data=torch.full_like(t_rows.data, -1.0))
            for k in range(self.refreshes):
                x = sc0.x if k == 0 else traj[k - 1, -1].to(ref.device)
                b = sensor.reveal_raycast_plain(b, t_rows, x[rows], f["sensor_range"], win,
                                                occupied_threshold=thr, chunk=1024)
                if k in self.later.get(i, {}):
                    # the refresh's first tick, from the program's state there, on
                    # the reference's own target and world of these scenarios
                    sc_k, off = self.later[i][k]
                    exact += off
                    with ref._precision():
                        phik_k = phik_dense_plain(b.data, ops, r, ref.config.mi_frontier_cells,
                                                  thr)
                        world_k = ref._world(b, b.domain())
                    sc1, _, d1 = ref.tick(take_rows(program.to_ref(sc_k), rows), phik_k,
                                          world_k)
                    gaps["x"].append(abs_gap(traj[k, 0][rows][:, :2], sc1.x[:, :2]))
                    gaps["metric"].append(rel_gap(metric[k, 0][rows], d1.ergodic_metric, 1e-6))
                if k in studied and not counts_done:
                    got = m_work.facts_from(b.data, ops, self.cfg, r)
                    got.update(reveal_work.facts_from(t_rows.data, x[rows], f["resolution"],
                                                      win, 256, thr))
                    counts.append({k: v * ctx.scenarios / len(rows) if k in SUMMED else v
                                   for k, v in got.items()})
            exact += cells_off(belief.data[rows], b.data)
            exact += cells_off(cov[-1], sensor.fraction_known_plain(belief))
            counts_done = True
            ring = ref.init_scenarios(x0).state.buffer
            fed = torch.cat([sc0.x[None], traj.reshape(-1, *traj.shape[2:])[:-1].to(ref.device)])
            for p in fed:
                ring = ring.append(p[:, :2])
            exact += ring_off(sc_out.state.buffer, ring)
            exact += cells_off(sc_out.state.hist_count,
                               torch.full_like(sc_out.state.hist_count, self.ticks_per_request))
        self.facts = k1_facts(ctx, ref, world, ticks)
        for key in ("m_nonzero", "m_cells", "reveal_occupied", "reveal_blocked_bins"):
            self.facts[key] = sum(c[key] for c in counts) / len(counts)
        self.facts["window_cells"] = counts[0]["window_cells"]
        self.facts["sensor_radius_cells"] = r
        return limits(ctx, {"x_gap_p99": p99(gaps["x"]), "metric_rel_p99": p99(gaps["metric"]),
                            "state_cells_off": exact})
