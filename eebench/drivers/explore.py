"""Closed-loop exploration calls, back to back: each request is one
``Engine.explore`` call of ``ticks_per_call`` ticks on S distinct maps (a
wall and a pillar at per-scenario places), continuing from the state the
last call ended in, and ends with its trajectory and controls on the host.
The GMM targets' coefficients are made once at set-up by
``Engine.phik_from_gmm`` (K2, masked by each map's free space).

Traffic parameters: ``ticks_per_call``; ``spawn_clearance`` (m, the start
poses' distance from their own map's obstacles); ``samples``, the calls
after the first that the check compares.

The check, for the first call and the sampled ones: the plain reference
works out the world and the target coefficients again from the harness's
arrays and runs the call's first tick from the state the call started in
(its own initial state for the first call); compared are that tick's
control and its ergodic metric. A later tick of the call, drawn from the
seed at a multiple of the call's graph block, is compared the same way:
after the window the program reruns the call's prefix up to that tick
through the same entry point at the cell's size (its trajectory and
controls must equal the call's, exactly), and the reference runs the next
tick from the state the prefix ends in. Every tick's pose must be the
reference kinematics' advance of the pose before it under the tick's
control, exactly. The ring of the call's final state must hold, in order,
the pose each tick started from (the trajectory's, and the call's start),
its history count the ticks run, exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from eebench import gen, program
from eebench.drivers import (Request, Samples, abs_gap, cells_off, k1_facts, later_points, limits,
                             p99, rel_gap, ring_off)

record = torch.profiler.record_function
BLOCK = 10  # ticks of the program's explore graph: a prefix of whole blocks replays it


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.facts = {}
        self.later = {}  # the prefixes' states, made at release
        self.refreshes_per_request = 0  # no map refresh in these requests
        self.ticks_per_request = int(ctx.param("ticks_per_call"))

    def _case(self, prog):
        ctx, f = self.ctx, self.ctx.config["fleet"]
        S, res = ctx.scenarios, f["resolution"]
        eng = prog.make_engine(self.cfg, ctx.device)
        dom = prog.Domain.create(*f["domain"], device=eng.device)
        grids = prog.GridMap(torch.as_tensor(self.maps, device=eng.device),
                             torch.zeros((S, 2), device=eng.device),
                             torch.full((S,), res, device=eng.device))
        world = eng.prepare_world(grids)
        gmm = prog.GaussianMixture.create(*self.mix, device=eng.device)
        phik = eng.phik_from_gmm(gmm, dom, world.free_mask)
        return eng, phik, world, eng.init_scenarios(self.x0)

    def setup(self):
        ctx, f = self.ctx, self.ctx.config["fleet"]
        self.cfg = ctx.engine_config
        S, side = ctx.scenarios, f["domain"][2]
        self.maps, rects = gen.distinct_rooms(gen.rng(ctx.seed, 1), S, f["cells"],
                                              f["resolution"])
        self.x0 = gen.spawn_clear_of(gen.rng(ctx.seed, 2), rects, ctx.param("spawn_clearance"),
                                     0.5, side - 0.5)
        lo, hi = f["gmm_mean_range"]
        self.mix = gen.mixtures(gen.rng(ctx.seed, 3), S, f["gmm_components"], f["gmm_cov"], lo,
                                hi)
        self.engine, self.phik, self.world, self.sc = self._case(ctx.program)
        out = self.engine.explore(self.sc, self.phik, self.world, self.ticks_per_request)
        out.trajectory.cpu()  # the call's graphs are captured and replayed once
        self.samples = Samples(ctx.seed, ctx.param("samples"))
        self.i = 0

    def request(self) -> Request:
        sc = self.sc
        t0 = time.perf_counter()
        with record("eebench.explore"):
            out = self.engine.explore(sc, self.phik, self.world, self.ticks_per_request)
        t1 = time.perf_counter()
        with record("eebench.readback"):
            traj, ctrl = out.trajectory.cpu(), out.controls.cpu()
        ok = bool(np.isfinite(traj.numpy()).all() and np.isfinite(ctrl.numpy()).all())
        self.samples.offer(self.i, lambda: (sc, out))
        self.sc = out.scenarios
        self.i += 1
        return Request(self.ctx.scenarios * self.ticks_per_request, ok, None, t1 - t0)

    def release(self):
        """After the window: each compared call's prefix up to a seeded later
        tick, rerun through the timed entry point; then the program's state
        is freed."""
        ticks = self.ticks_per_request
        block = BLOCK if ticks % BLOCK == 0 else 1
        self.later = {}
        for i, (sc_in, out) in self.samples.all():
            for j in later_points(gen.rng(self.ctx.seed, 97, i), 1, ticks, block):
                pre = self.engine.explore(sc_in, self.phik, self.world, j)
                off = cells_off(pre.trajectory, out.trajectory[:j])
                off += cells_off(pre.controls, out.controls[:j])
                self.later[i] = (j, pre.scenarios, off)
        self.engine = self.phik = self.world = self.sc = None

    def check(self):
        from eebench.reference.ops.integrator import rollout

        eng, phik, world, sc0 = self._case(program.reference())
        gaps = {"u": [], "metric": []}
        exact = steps_off = 0
        ticks = []
        for i, (sc_in, out) in self.samples.all():
            start = sc0 if i == 0 else program.to_ref(sc_in)
            sc1, u1, d1 = eng.tick(start, phik, world)
            ticks.append((start.x, start.vb, u1, d1))
            gaps["u"].append(abs_gap(out.controls[0], u1))
            gaps["metric"].append(rel_gap(out.diag.ergodic_metric[0], d1.ergodic_metric, 1e-6))
            if i in self.later:  # the seeded later tick, from the prefix's state
                j, sc_j, off = self.later[i]
                exact += off
                sc_j = program.to_ref(sc_j)
                sc1, u1, d1 = eng.tick(sc_j, phik, world)
                ticks.append((sc_j.x, sc_j.vb, u1, d1))
                gaps["u"].append(abs_gap(out.controls[j], u1))
                gaps["metric"].append(rel_gap(out.diag.ergodic_metric[j], d1.ergodic_metric,
                                              1e-6))
            # every tick's pose: the kinematics' advance of the one before
            fed = torch.cat([sc_in.x[None], out.trajectory[:-1]]).to(eng.device)
            with eng._precision():
                moved = rollout(eng.model, fed, out.controls.to(eng.device)[..., None, :],
                                eng.config.dt)[..., -1, :]
            steps_off += cells_off(out.trajectory, moved)
            # the ring: the pose each tick started from, appended in order
            ring = program.to_ref(sc_in.state.buffer)
            ring = type(ring)(ring.states.clone(), ring.cursor, ring.count)
            for p in fed:
                ring = ring.append(p[:, :2])
            exact += ring_off(out.scenarios.state.buffer, ring)
            exact += cells_off(out.scenarios.state.hist_count,
                               sc_in.state.hist_count + self.ticks_per_request)
            exact += cells_off(out.scenarios.x, out.trajectory[-1])
        self.facts = k1_facts(self.ctx, eng, world, ticks)
        return limits(self.ctx, {"u_gap_p99": p99(gaps["u"]), "metric_rel_p99": p99(gaps["metric"]),
                                 "pose_step_cells_off": steps_off, "state_cells_off": exact})
