"""A fleet's replan ticks, back to back: each tick hands the program the
poses of S robots from the harness's own plant, the program replans every
robot through one single-tick entry point, and the (S, nu) controls come
back to the host, where the plant moves the robots one dt with them.

Traffic parameters: ``target`` ``"gmm"`` (``Engine.replan_refresh``: the
GMM target refreshed every tick, on one shared wall-and-pillar map) or
``"mi"`` (``Engine.replan_refresh_mi`` with K3: the MI target recomputed
every tick from per-scenario beliefs that set-up reveals around
``belief_points`` seeded points of ``belief_radius`` m and that stay fixed,
as between map updates; ``sensor_radius_cells`` is K3's radius);
``samples``, the ticks after the first that the check compares.

The check: for the first tick and the sampled ones, the plain reference
runs the same tick from the same poses and, for the first, from its own
initial state, for the others from the state the program handed to that
tick (the reference cannot follow the closed loop, which two correct
versions leave by rounding within a few ticks). Every other input (the
world, the target's operands) the reference works out again from the
harness's arrays. Compared: the controls, the next warm start U, the
ergodic metric, and the state's ring, history count and keys exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from eebench import gen, program
from eebench.drivers import (Request, Samples, abs_gap, cells_off, k1_facts, limits, p99, rel_gap,
                             ring_off)

record = torch.profiler.record_function


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.facts = {}
        self.refreshes_per_request = 0  # no map refresh in these requests
        self.ticks_per_request = 1

    def _inputs(self):
        """The cell's arrays, from the seed: (x0 (S, 3), maps (S, h, w) on
        the device, GMM arrays or None)."""
        ctx, f = self.ctx, self.ctx.config["fleet"]
        cfg = self.cfg
        S, cells, res = ctx.scenarios, f["cells"], f["resolution"]
        need = cfg["boundary_radius"] + cfg["d_safe"]
        side = f["domain"][2]
        if ctx.traffic["target"] == "gmm":
            data = gen.wall_and_pillar(cells)
            x0 = gen.spawn(gen.rng(ctx.seed, 1), S, gen.clearance(data, res), res, need, 0.3,
                           side - 0.3)
            lo, hi = f["gmm_mean_range"]
            mix = gen.mixtures(gen.rng(ctx.seed, 2), S, f["gmm_components"], f["gmm_cov"], lo,
                               hi)
            maps = torch.as_tensor(data, device=ctx.device).expand(S, cells, cells)
            return x0, maps, mix
        truth = gen.building()
        clear = gen.clearance(truth, res)
        g = gen.rng(ctx.seed, 3)
        maps = gen.disc_beliefs(truth, g, S, ctx.param("belief_points"),
                                ctx.param("belief_radius"), res, clear, need, ctx.device)
        # each robot starts at a pose of its own first disc, which is known and free
        x0 = gen.spawn(gen.rng(ctx.seed, 3), S, clear, res, need, 0.3, side - 0.3)
        return x0, maps, None

    def _case(self, prog, x0, maps, mix):
        """(engine, tick function, initial Scenarios) of ``prog`` on the
        arrays."""
        ctx, f = self.ctx, self.ctx.config["fleet"]
        S, res = ctx.scenarios, f["resolution"]
        eng = prog.make_engine(self.cfg, ctx.device)
        dom = prog.Domain.create(*f["domain"], device=eng.device)
        grids = prog.GridMap(maps, torch.zeros((S, 2), device=eng.device),
                             torch.full((S,), res, device=eng.device))
        if mix is not None:
            world = eng.prepare_world(grids, domain=None)
            gmm = prog.GaussianMixture.create(*mix, device=eng.device)

            def tick(sc):
                return eng.replan_refresh(sc, gmm, dom, world)
        else:
            world = eng.prepare_world(grids)
            r = ctx.param("sensor_radius_cells")

            def tick(sc):
                return eng.replan_refresh_mi(sc, grids, world, r, dom, use_mi_kernel=True)
        self.world = world
        return eng, tick, eng.init_scenarios(x0)

    def setup(self):
        ctx = self.ctx
        self.cfg = ctx.engine_config
        self.x0, self.maps, self.mix = self._inputs()
        self.engine, self.tick, sc0 = self._case(ctx.program, self.x0, self.maps, self.mix)
        self.Scenarios = type(sc0)
        self.plant = gen.Plant(self.cfg)
        for _ in range(2):  # captures the tick's graph, then replays it
            _, u, _ = self.tick(sc0)
            u.cpu()
        self.state = sc0.state
        self.x = self.x0.copy()
        self.vb = np.zeros_like(self.x0)
        self.samples = Samples(ctx.seed, ctx.param("samples"))
        self.i = 0

    def request(self) -> Request:
        dev = self.ctx.device
        t0 = time.perf_counter()
        with record("eebench.upload"):
            x = torch.from_numpy(self.x).to(dev)
            vb = torch.from_numpy(self.vb).to(dev)
        sc = self.Scenarios(self.state, x, vb)
        t1 = time.perf_counter()
        with record("eebench.replan"):
            out, u, diag = self.tick(sc)
        t2 = time.perf_counter()
        with record("eebench.readback"):
            u_host = u.cpu().numpy()
        latency = time.perf_counter() - t0
        xs, vbs = self.x, self.vb
        self.samples.offer(self.i, lambda: (sc.state, xs, vbs, out.state, u, diag))
        with record("eebench.plant"):
            self.x, self.vb = self.plant.step(self.x, u_host)
        self.state = out.state
        self.i += 1
        return Request(self.ctx.scenarios, bool(np.isfinite(u_host).all()), latency, t2 - t1)

    def release(self):
        self.engine = self.tick = self.state = None

    def check(self):
        ctx = self.ctx
        ref_prog = program.reference()
        eng, tick, sc0 = self._case(ref_prog, self.x0, self.maps, self.mix)
        gaps = {"u": [], "U": [], "metric": []}
        exact = 0
        ticks = []
        for i, (state_in, x, vb, state_out, u, diag) in self.samples.all():
            state = sc0.state if i == 0 else program.to_ref(state_in)
            sc = type(sc0)(state, torch.from_numpy(x).to(eng.device),
                           torch.from_numpy(vb).to(eng.device))
            out_r, u_r, d_r = tick(sc)
            ticks.append((sc.x, sc.vb, u_r, d_r))
            gaps["u"].append(abs_gap(u, u_r))
            gaps["U"].append(abs_gap(state_out.U, out_r.state.U))
            gaps["metric"].append(rel_gap(diag.ergodic_metric, d_r.ergodic_metric, 1e-6))
            exact += ring_off(state_out.buffer, out_r.state.buffer)
            exact += cells_off(state_out.hist_count, out_r.state.hist_count)
            exact += cells_off(state_out.rng, out_r.state.rng)
        self.facts = k1_facts(ctx, eng, self.world, ticks)
        self.facts["gmm_components"] = None if self.mix is None else self.mix.means.shape[1]
        self.facts["sensor_radius_cells"] = ctx.traffic.get("sensor_radius_cells", 0)
        return limits(ctx, {"u_gap_p99": p99(gaps["u"]), "U_gap_p99": p99(gaps["U"]),
                            "metric_rel_p99": p99(gaps["metric"]), "state_cells_off": exact})
